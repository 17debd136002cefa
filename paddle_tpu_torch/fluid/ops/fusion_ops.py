"""Fused-op lowerings: the port's counterpart of
``paddle_tpu/fluid/ops/fusion_ops.py``, all 14 of its lowerings (reference:
operators/fused/*, attention_lstm_op.cc, conv_fusion_op.cc).

The reference hand-writes these kernels because its interpreter cannot
fuse across op boundaries; the JAX package emits the constituent ops and
lets XLA fuse them. The port does the same on PyTorch: each lowering calls
the port's own lowering of its parts through ``get_lowering`` (``lstm``,
``gru``, ``sequence_conv``, ``sequence_pool``, ``conv2d``) or a plain
``torch.matmul``, so a pre-fused program runs and gives the unfused
program's values. None reaches a hand-written kernel: the JAX module
reaches no ``pl.pallas_call``. Their gradients are the generic
``grad_of`` (ops/grad_ops.py), as the JAX package's are ``jax.vjp``.

- The embedding fusions gather rows as ``jnp.take`` does: a negative id
  wraps once, an id past either end gives a NaN row (``_take_rows``); a
  masked row of NaN stays NaN (NaN times 0).
- ``attention_lstm`` runs its T steps as a Python loop on the device with
  no host read; a row of length 0 softmaxes an all -inf row to NaN, as in
  JAX.
- ``conv2d_fusion``'s ``_ACT`` has the JAX table's names only: another
  activation (``relu6``, ``leaky_relu``) raises ``KeyError``, as there.
"""
import torch
import torch.nn.functional as F

from .registry import register_lowering, get_lowering
from .common import one, many, align_rank

_ACT = {
    "relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "identity": lambda x: x, "": lambda x: x, None: lambda x: x,
    # jax.nn.gelu's default is the tanh form
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def _take_rows(table, ids):
    """``jnp.take(table, ids, axis=0)``: ids in [-V, 0) wrap once, any
    other id outside [0, V) gives a row of NaN (its gradient 0)."""
    v = table.shape[0]
    idx = ids.long()
    idx = torch.where(idx < 0, idx + v, idx)
    valid = (idx >= 0) & (idx < v)
    rows = table[torch.clamp(idx, 0, v - 1)]
    return torch.where(valid[..., None], rows,
                       torch.full((), float("nan"), dtype=table.dtype,
                                  device=table.device))


@register_lowering("fused_elemwise_activation")
def _fused_elemwise_activation(ctx, inputs, attrs):
    """functor_list = [binary, unary] or [unary, binary]
    (fused_elemwise_activation_op.cc)."""
    x = one(inputs, "X")
    y = one(inputs, "Y")
    functors = [f.split(",")[0] for f in attrs.get("functor_list", [])]
    axis = attrs.get("axis", -1)
    scale = attrs.get("scale", 0.0)

    def unary(name, v):
        if name == "scale":
            return v * scale
        return _ACT[name](v)

    def binary(name, a, b):
        b = align_rank(a, b, axis)
        return {"elementwise_add": torch.add, "elementwise_sub": torch.sub,
                "elementwise_mul": torch.mul}[name](a, b)

    if functors[0].startswith("elementwise"):
        inter = unary(functors[1], y)
        out = binary(functors[0], x, inter)
    else:
        inter = binary(functors[1], x, y)
        out = unary(functors[0], inter)
    return {"Out": [out], "IntermediateOut": [inter]}


def _seq_fused_rnn(ctx, x_proj, inputs, attrs, kind):
    """The shared tail of fusion_lstm, fused_embedding_fc_lstm and
    fusion_gru: the registered full-sequence recurrence on the projected
    input."""
    sub = {"Input": [x_proj], "Weight": [one(inputs, "WeightH")],
           "Bias": [one(inputs, "Bias")], "H0": [one(inputs, "H0")],
           "Length": [one(inputs, "Length")]}
    if kind == "lstm":
        sub["C0"] = [one(inputs, "C0")]
        return get_lowering("lstm")(ctx, sub, attrs)
    return get_lowering("gru")(ctx, sub, attrs)


@register_lowering("fusion_lstm")
def _fusion_lstm(ctx, inputs, attrs):
    """x·WeightX then the lstm recurrence (fusion_lstm_op.cc:125-180)."""
    xx = torch.matmul(one(inputs, "X"), one(inputs, "WeightX"))
    outs = _seq_fused_rnn(ctx, xx, inputs, attrs, "lstm")
    outs["XX"] = [xx]
    return outs


@register_lowering("fusion_gru")
def _fusion_gru(ctx, inputs, attrs):
    xx = torch.matmul(one(inputs, "X"), one(inputs, "WeightX"))
    outs = _seq_fused_rnn(ctx, xx, inputs, attrs, "gru")
    outs["XX"] = [xx]
    return outs


@register_lowering("fused_embedding_fc_lstm")
def _fused_embedding_fc_lstm(ctx, inputs, attrs):
    """Embeddings hold W_emb·W_x already ([V, 4D]): the lookup replaces the
    input projection (fused_embedding_fc_lstm_op.cc:123-175)."""
    ids = one(inputs, "Ids")                # [B, T] or [B, T, 1]
    if ids.dim() == 3:
        ids = ids[..., 0]
    xx = _take_rows(one(inputs, "Embeddings"), ids)
    outs = _seq_fused_rnn(ctx, xx, inputs, attrs, "lstm")
    outs["XX"] = [xx]
    return outs


@register_lowering("fused_embedding_seq_pool")
def _fused_embedding_seq_pool(ctx, inputs, attrs):
    """lookup_table + sequence_pool(sum) (fused_embedding_seq_pool_op.cc):
    the rows past a sequence's Length are multiplied by 0."""
    ids = one(inputs, "Ids")
    length = one(inputs, "Length")
    if ids.dim() == 3:
        ids = ids[..., 0]
    emb = _take_rows(one(inputs, "W"), ids)     # [B, T, D]
    if length is not None:
        steps = torch.arange(ids.shape[1], device=ids.device)
        mask = (steps[None, :] < length.reshape(-1, 1)).to(emb.dtype)
        emb = emb * mask[:, :, None]
    return {"Out": [torch.sum(emb, dim=1)]}


@register_lowering("fusion_seqconv_eltadd_relu")
def _fusion_seqconv_eltadd_relu(ctx, inputs, attrs):
    """sequence_conv + bias + relu (fusion_seqconv_eltadd_relu_op.cc:69-106)."""
    sub = {"X": [one(inputs, "X")], "Filter": [one(inputs, "Filter")],
           "Length": [one(inputs, "Length")]}
    conv_attrs = {"contextLength": attrs.get("contextLength"),
                  "contextStart": attrs.get("contextStart", 0),
                  "contextStride": attrs.get("contextStride", 1)}
    out = get_lowering("sequence_conv")(ctx, sub, conv_attrs)["Out"][0]
    bias = one(inputs, "Bias")
    if bias is not None:
        out = out + bias.reshape(1, 1, -1)
    return {"Out": [torch.relu(out)]}


@register_lowering("fusion_seqexpand_concat_fc")
def _fusion_seqexpand_concat_fc(ctx, inputs, attrs):
    """The first X is [B, T, D0]; the rest are per-sequence [B, Di],
    broadcast over the padded T (no Length is read); the features
    concatenated, one fc and its activation
    (fusion_seqexpand_concat_fc_op.cc)."""
    xs = many(inputs, "X")
    b = one(inputs, "FCBias")
    base = xs[0]
    t = base.shape[1]
    feats = [base] + [xi[:, None, :].expand(xi.shape[0], t, xi.shape[-1])
                      for xi in xs[1:]]
    out = torch.matmul(torch.cat(feats, dim=-1), one(inputs, "FCWeight"))
    if b is not None:
        out = out + b.reshape(1, 1, -1)
    return {"Out": [_ACT[attrs.get("fc_activation", "identity")](out)]}


@register_lowering("fusion_seqpool_concat")
def _fusion_seqpool_concat(ctx, inputs, attrs):
    """sequence_pool over every input, concatenated along axis
    (fusion_seqpool_concat_op.cc:54-61)."""
    pool = get_lowering("sequence_pool")
    ptype = attrs.get("pooltype", "SUM")
    lengths = many(inputs, "Length")
    outs = []
    for i, x in enumerate(many(inputs, "X")):
        sub = {"X": [x],
               "Length": [lengths[i] if i < len(lengths) else None]}
        outs.append(pool(ctx, sub, {"pooltype": ptype})["Out"][0])
    return {"Out": [torch.cat(outs, dim=attrs.get("axis", 1))]}


@register_lowering("fusion_squared_mat_sub")
def _fusion_squared_mat_sub(ctx, inputs, attrs):
    """scalar·((X·Y)² − X²·Y²) (fusion_squared_mat_sub_op.cc:61-67): the
    FM second-order interaction."""
    x = one(inputs, "X")
    y = one(inputs, "Y")
    scalar = attrs.get("scalar", 1.0)
    xy = torch.matmul(x, y)
    x2, y2 = x * x, y * y
    x2y2 = torch.matmul(x2, y2)
    out = scalar * (xy * xy - x2y2)
    return {"SquaredX": [x2], "SquaredY": [y2], "SquaredXY": [xy * xy],
            "Out": [out]}


@register_lowering("fusion_repeated_fc_relu")
def _fusion_repeated_fc_relu(ctx, inputs, attrs):
    """A chain of fc + relu (fusion_repeated_fc_relu_op.cc:68-75)."""
    ws = many(inputs, "W")
    bs = many(inputs, "Bias")
    relu_outs = []
    h = one(inputs, "X")
    for i, w in enumerate(ws):
        h = torch.matmul(h.reshape(h.shape[0], -1), w)
        if i < len(bs) and bs[i] is not None:
            h = h + bs[i].reshape(1, -1)
        h = torch.relu(h)
        relu_outs.append(h)
    return {"ReluOut": relu_outs[:-1], "Out": [relu_outs[-1]]}


@register_lowering("fusion_transpose_flatten_concat")
def _fusion_transpose_flatten_concat(ctx, inputs, attrs):
    """transpose(trans_axis) -> flatten(flatten_axis) -> concat(concat_axis)
    (fusion_transpose_flatten_concat_op.cc:79-97)."""
    trans = list(attrs.get("trans_axis"))
    fa = attrs.get("flatten_axis", 1)
    ca = attrs.get("concat_axis", 1)
    outs = []
    for x in many(inputs, "X"):
        xt = x.permute(trans)
        lead = 1
        for d in xt.shape[:fa]:
            lead *= d
        outs.append(xt.reshape(lead, -1))
    return {"Out": [torch.cat(outs, dim=ca)]}


@register_lowering("conv2d_fusion")
def _conv2d_fusion(ctx, inputs, attrs):
    """conv + bias (+ residual) + activation (conv_fusion_op.cc)."""
    out = get_lowering("conv2d")(ctx, {"Input": [one(inputs, "Input")],
                                       "Filter": [one(inputs, "Filter")]},
                                 attrs)["Output"][0]
    bias = one(inputs, "Bias")
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    resid = one(inputs, "ResidualData")
    if resid is not None:
        out = out + resid
    return {"Output": [_ACT[attrs.get("activation", "relu")](out)]}


@register_lowering("conv2d_inception_fusion")
def _conv2d_inception_fusion(ctx, inputs, attrs):
    """Every filter applied to the block's input with padding (k - 1) // 2,
    a bias and a relu each, concatenated on the channels
    (fusion_conv_inception_op.cc's four aggregated filters)."""
    x = one(inputs, "Input")
    biases = many(inputs, "Bias")
    conv = get_lowering("conv2d")
    outs = []
    for i, f in enumerate(many(inputs, "Filter")):
        pad = (f.shape[2] - 1) // 2
        o = conv(ctx, {"Input": [x], "Filter": [f]},
                 {"strides": [1, 1], "paddings": [pad, pad],
                  "dilations": [1, 1], "groups": 1})["Output"][0]
        if i < len(biases) and biases[i] is not None:
            o = o + biases[i].reshape(1, -1, 1, 1)
        outs.append(torch.relu(o))
    return {"Output": [torch.cat(outs, dim=1)]}


@register_lowering("attention_lstm")
def _attention_lstm(ctx, inputs, attrs):
    """Attention over the input sequence at each step, then an LSTM step on
    the attended context (attention_lstm_op.cc:129-210), over a dense
    [B, T, M] batch and its Length mask. AttentionWeight [M+D, 1] has the
    x rows first and the previous cell's rows last; LSTMWeight [D+M, 4D]
    has the hidden rows first; the gates are [forget, input, output,
    candidate]."""
    x = one(inputs, "X")                  # [B, T, M]
    c0 = one(inputs, "C0")                # [B, D]
    h0 = one(inputs, "H0")
    aw = one(inputs, "AttentionWeight")
    ab = one(inputs, "AttentionBias")
    ascalar = one(inputs, "AttentionScalar")
    ascalar_b = one(inputs, "AttentionScalarBias")
    lw = one(inputs, "LSTMWeight")
    lb = one(inputs, "LSTMBias")
    length = one(inputs, "Length")
    gate_act = _ACT[attrs.get("gate_activation", "sigmoid")]
    cell_act = _ACT[attrs.get("cell_activation", "tanh")]
    cand_act = _ACT[attrs.get("candidate_activation", "tanh")]
    b, t, m = x.shape
    d = c0.shape[1]
    if h0 is None:
        h0 = torch.zeros_like(c0)
    aw_x, aw_h = aw[:m], aw[m:]
    lw_h, lw_x = lw[:d], lw[d:]
    score_x = torch.matmul(x, aw_x)[..., 0]          # [B, T]
    if ab is not None:
        score_x = score_x + ab.reshape(-1)[0]
    steps = torch.arange(t, device=x.device)
    if length is not None:
        lens = length.reshape(-1)
        tmask = steps[None, :] < lens[:, None]
    else:
        tmask = torch.ones((b, t), dtype=torch.bool, device=x.device)
    neg_inf = torch.full((), float("-inf"), dtype=x.dtype, device=x.device)
    h_prev, c_prev = h0, c0
    hs, cs = [], []
    for k in range(t):
        s = torch.relu(score_x + torch.matmul(c_prev, aw_h).reshape(b, 1))
        if ascalar is not None:
            s = s * ascalar.reshape(-1)[0]
            if ascalar_b is not None:
                s = s + ascalar_b.reshape(-1)[0]
            s = torch.relu(s)
        s = torch.where(tmask, s, neg_inf)
        a = torch.softmax(s, dim=1)
        ctxv = torch.matmul(a[:, None, :], x)[:, 0]       # [B, M]
        gates = torch.matmul(ctxv, lw_x) + torch.matmul(h_prev, lw_h)
        if lb is not None:
            gates = gates + lb.reshape(1, -1)
        f = gate_act(gates[:, :d])
        i = gate_act(gates[:, d:2 * d])
        o = gate_act(gates[:, 2 * d:3 * d])
        cand = cand_act(gates[:, 3 * d:])
        c = f * c_prev + i * cand
        h = o * cell_act(c)
        if length is not None:
            alive = (steps[k] < lens).to(h.dtype)[:, None]
            h = alive * h + (1 - alive) * h_prev
            c = alive * c + (1 - alive) * c_prev
        h_prev, c_prev = h, c
        hs.append(h)
        cs.append(c)
    return {"Hidden": [torch.stack(hs, dim=1)],
            "Cell": [torch.stack(cs, dim=1)],
            "AttentionedX": [score_x.reshape(b * t, 1)]}
