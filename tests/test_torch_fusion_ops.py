"""The fused-op lowerings (``paddle_tpu_torch/fluid/ops/fusion_ops.py``'s
14) against the JAX package's on the same seeded numpy inputs, on the CPU.

- Forwards: every output of every case within 1e-5 of the largest JAX
  magnitude of that output.
- Gradients through each package's backward (``fluid.gradients``: the
  port's ``grad_of`` on the taped forward, the JAX package's ``jax.vjp``)
  of sum(out * cotangent) over every float output, with respect to every
  float input, each within 1e-4 of its largest JAX value.
- Each fused op against its unfused composition on the port (as
  tests/test_fusion_ops.py holds the JAX package's), within 1e-5.
- The JAX values the port keeps: ``jnp.take``'s negative ids (wrapped)
  and ids past the end (NaN rows, NaN after the Length mask too);
  attention_lstm's row of length 0 (all -inf softmaxed to NaN); the
  inception fusion's even filter (outputs of two sizes: the concat
  raises); conv2d_fusion's activations outside its table (KeyError).
- Build-time shape inference gives the real run's shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.fluid.ops import registry as jreg
from paddle_tpu_torch.fluid.ops import registry as treg

TOL = 1e-5
GRAD_TOL = 1e-4
FUSION_OPS = {"fused_elemwise_activation", "fusion_lstm", "fusion_gru",
              "fused_embedding_fc_lstm", "fused_embedding_seq_pool",
              "fusion_seqconv_eltadd_relu", "fusion_seqexpand_concat_fc",
              "fusion_seqpool_concat", "fusion_squared_mat_sub",
              "fusion_repeated_fc_relu", "fusion_transpose_flatten_concat",
              "conv2d_fusion", "conv2d_inception_fusion", "attention_lstm"}
LSTM_ATTRS = {"gate_activation": "sigmoid", "cell_activation": "tanh",
              "candidate_activation": "tanh"}


def _randn(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _ids(*shape, high, seed):
    return np.random.RandomState(seed).randint(0, high, shape).astype(
        np.int64)


def _lens(*values):
    return np.array(values, np.int64)


# case -> (op type, {slot: [arrays]}, attrs, {output slot: count})
CASES = {
    "fused_elemwise_activation__add_relu": (
        "fused_elemwise_activation",
        {"X": [_randn(3, 4, seed=1)], "Y": [_randn(3, 4, seed=2)]},
        {"functor_list": ["elementwise_add", "relu"], "axis": -1},
        {"Out": 1, "IntermediateOut": 1}),
    "fused_elemwise_activation__gelu_of_bias_add": (
        "fused_elemwise_activation",
        {"X": [_randn(6, 5, seed=3)], "Y": [_randn(5, seed=4)]},
        {"functor_list": ["gelu", "elementwise_add"], "axis": -1},
        {"Out": 1, "IntermediateOut": 1}),
    "fused_elemwise_activation__mul_scale": (
        "fused_elemwise_activation",
        {"X": [_randn(2, 3, 4, seed=5)], "Y": [_randn(3, seed=6)]},
        {"functor_list": ["elementwise_mul", "scale"], "axis": 1,
         "scale": 0.5},
        {"Out": 1, "IntermediateOut": 1}),
    "fusion_lstm": (
        "fusion_lstm",
        {"X": [_randn(3, 5, 4, seed=7)], "WeightX": [_randn(4, 12, seed=8)],
         "WeightH": [_randn(3, 12, seed=9, scale=0.5)],
         "Bias": [_randn(1, 12, seed=10)], "H0": [_randn(3, 3, seed=11)],
         "C0": [_randn(3, 3, seed=12)], "Length": [_lens(5, 2, 4)]},
        LSTM_ATTRS, {"Hidden": 1, "Cell": 1, "XX": 1}),
    "fusion_lstm__reverse": (
        "fusion_lstm",
        {"X": [_randn(2, 4, 3, seed=13)], "WeightX": [_randn(3, 8, seed=14)],
         "WeightH": [_randn(2, 8, seed=15, scale=0.5)],
         "Bias": [_randn(1, 8, seed=16)], "Length": [_lens(4, 1)]},
        dict(LSTM_ATTRS, is_reverse=True), {"Hidden": 1, "Cell": 1, "XX": 1}),
    "fusion_gru": (
        "fusion_gru",
        {"X": [_randn(3, 4, 5, seed=17)], "WeightX": [_randn(5, 9, seed=18)],
         "WeightH": [_randn(3, 9, seed=19, scale=0.5)],
         "Bias": [_randn(1, 9, seed=20)], "Length": [_lens(4, 3, 1)]},
        {"activation": "relu", "gate_activation": "sigmoid"},
        {"Hidden": 1, "XX": 1}),
    "fusion_gru__reverse_origin": (
        "fusion_gru",
        {"X": [_randn(2, 3, 4, seed=21)], "WeightX": [_randn(4, 6, seed=22)],
         "WeightH": [_randn(2, 6, seed=23, scale=0.5)],
         "H0": [_randn(2, 2, seed=24)]},
        {"is_reverse": True, "origin_mode": True}, {"Hidden": 1, "XX": 1}),
    "fused_embedding_fc_lstm": (
        "fused_embedding_fc_lstm",
        {"Ids": [_ids(3, 4, 1, high=7, seed=25)],
         "Embeddings": [_randn(7, 8, seed=26)],
         "WeightH": [_randn(2, 8, seed=27, scale=0.5)],
         "Bias": [_randn(1, 8, seed=28)], "Length": [_lens(4, 2, 3)]},
        LSTM_ATTRS, {"Hidden": 1, "Cell": 1, "XX": 1}),
    "fused_embedding_seq_pool": (
        "fused_embedding_seq_pool",
        {"W": [_randn(9, 4, seed=29)], "Ids": [_ids(3, 5, high=9, seed=30)],
         "Length": [_lens(5, 1, 3)]},
        {"combiner": "sum"}, {"Out": 1}),
    "fusion_seqconv_eltadd_relu": (
        "fusion_seqconv_eltadd_relu",
        {"X": [_randn(2, 6, 4, seed=31)], "Filter": [_randn(12, 5, seed=32)],
         "Bias": [_randn(5, seed=33)], "Length": [_lens(6, 3)]},
        {"contextLength": 3, "contextStart": -1, "contextStride": 1},
        {"Out": 1}),
    "fusion_seqexpand_concat_fc": (
        "fusion_seqexpand_concat_fc",
        {"X": [_randn(2, 4, 3, seed=34), _randn(2, 2, seed=35),
               _randn(2, 5, seed=36)],
         "FCWeight": [_randn(10, 6, seed=37)], "FCBias": [_randn(6, seed=38)]},
        {"fc_activation": "tanh"}, {"Out": 1}),
    "fusion_seqpool_concat": (
        "fusion_seqpool_concat",
        {"X": [_randn(3, 4, 2, seed=39), _randn(3, 4, 3, seed=40)],
         "Length": [_lens(4, 2, 1), _lens(1, 4, 3)]},
        {"pooltype": "SUM", "axis": 1}, {"Out": 1}),
    "fusion_seqpool_concat__average": (
        "fusion_seqpool_concat",
        {"X": [_randn(2, 3, 2, seed=41), _randn(2, 3, 2, seed=42)],
         "Length": [_lens(3, 2), _lens(1, 3)]},
        {"pooltype": "AVERAGE", "axis": 1}, {"Out": 1}),
    "fusion_squared_mat_sub": (
        "fusion_squared_mat_sub",
        {"X": [_randn(5, 4, seed=43)], "Y": [_randn(4, 3, seed=44)]},
        {"scalar": 0.5},
        {"SquaredX": 1, "SquaredY": 1, "SquaredXY": 1, "Out": 1}),
    "fusion_repeated_fc_relu": (
        "fusion_repeated_fc_relu",
        {"X": [_randn(4, 2, 3, seed=45)],
         "W": [_randn(6, 5, seed=46), _randn(5, 5, seed=47),
               _randn(5, 3, seed=48)],
         "Bias": [_randn(5, seed=49), _randn(5, seed=50), _randn(3, seed=51)]},
        {}, {"ReluOut": 2, "Out": 1}),
    "fusion_transpose_flatten_concat": (
        "fusion_transpose_flatten_concat",
        {"X": [_randn(2, 8, 3, 3, seed=52), _randn(2, 12, 2, 2, seed=53)]},
        {"trans_axis": [0, 2, 3, 1], "flatten_axis": 1, "concat_axis": 1},
        {"Out": 1}),
    "conv2d_fusion": (
        "conv2d_fusion",
        {"Input": [_randn(2, 3, 6, 6, seed=54)],
         "Filter": [_randn(4, 3, 3, 3, seed=55)], "Bias": [_randn(4, seed=56)],
         "ResidualData": [_randn(2, 4, 6, 6, seed=57)]},
        {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
         "groups": 1, "activation": "relu"}, {"Output": 1}),
    "conv2d_fusion__strided_identity": (
        "conv2d_fusion",
        {"Input": [_randn(2, 4, 7, 7, seed=58)],
         "Filter": [_randn(6, 2, 3, 3, seed=59)], "Bias": [_randn(6, seed=60)]},
        {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
         "groups": 2, "activation": "identity"}, {"Output": 1}),
    "conv2d_inception_fusion": (
        "conv2d_inception_fusion",
        {"Input": [_randn(2, 3, 5, 5, seed=61)],
         "Filter": [_randn(2, 3, 1, 1, seed=62), _randn(3, 3, 3, 3, seed=63),
                    _randn(2, 3, 5, 5, seed=64), _randn(1, 3, 1, 1, seed=65)],
         "Bias": [_randn(2, seed=66), _randn(3, seed=67), _randn(2, seed=68),
                  _randn(1, seed=69)]},
        {}, {"Output": 1}),
    "attention_lstm": (
        "attention_lstm",
        {"X": [_randn(3, 4, 3, seed=70)], "C0": [_randn(3, 2, seed=71)],
         "H0": [_randn(3, 2, seed=72)],
         "AttentionWeight": [_randn(5, 1, seed=73)],
         "AttentionBias": [_randn(1, 1, seed=74)],
         "AttentionScalar": [_randn(1, 1, seed=75)],
         "AttentionScalarBias": [_randn(1, 1, seed=76)],
         "LSTMWeight": [_randn(5, 8, seed=77)],
         "LSTMBias": [_randn(1, 8, seed=78)], "Length": [_lens(4, 2, 3)]},
        LSTM_ATTRS, {"Hidden": 1, "Cell": 1, "AttentionedX": 1}),
    "attention_lstm__no_scalar_no_length": (
        "attention_lstm",
        {"X": [_randn(2, 3, 4, seed=79)], "C0": [_randn(2, 3, seed=80)],
         "AttentionWeight": [_randn(7, 1, seed=81)],
         "LSTMWeight": [_randn(7, 12, seed=82)]},
        LSTM_ATTRS, {"Hidden": 1, "Cell": 1, "AttentionedX": 1}),
}


def _op(case):
    return CASES[case][0]


def _j(arrays):
    return {k: [jnp.asarray(a.astype(np.int32) if a.dtype == np.int64
                            else a) for a in v] for k, v in arrays.items()}


def _t(arrays):
    return {k: [torch.from_numpy(np.ascontiguousarray(a)) for a in v]
            for k, v in arrays.items()}


def _jax(op, arrays, attrs):
    return jax.jit(lambda ins: jreg.get_lowering(op)(
        jreg.LoweringContext(), ins, attrs))(_j(arrays))


def _port(op, arrays, attrs):
    return treg.get_lowering(op)(treg.LoweringContext("cpu"), _t(arrays),
                                 attrs)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _check(got, want, msg, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape, msg)
    bound = tol * (np.abs(want).max() or 1.0)
    assert np.abs(got.astype(np.float64) - want).max() <= bound, msg


def test_the_cases_cover_the_slice():
    """The 14 lowerings of the JAX fusion_ops.py, each with a case,
    registered in the port's fusion_ops.py, none with a grad maker (the
    generic grad_of serves them, as jax.vjp does the JAX package's); the
    port holds 311 (297 before this slice), none the JAX package lacks."""
    assert {_op(c) for c in CASES} == FUSION_OPS
    assert {op for op in jreg._LOWERINGS if jreg._LOWERINGS[op].__module__
            .endswith("fusion_ops")} == FUSION_OPS
    for op in FUSION_OPS:
        assert treg._LOWERINGS[op].__module__.endswith("fusion_ops"), op
        assert not treg.has_grad_maker(op) and not treg.is_no_grad(op)
    assert len(treg._LOWERINGS) == 311
    assert set(treg._LOWERINGS) <= set(jreg._LOWERINGS)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    op, arrays, attrs, outs = CASES[case]
    want = _jax(op, arrays, attrs)
    got = _port(op, arrays, attrs)
    assert set(got) == set(want) >= set(outs)
    for slot, w in want.items():
        assert len(got[slot]) == len(w)
        for g, v in zip(got[slot], w):
            _check(g, v, (case, slot))


def _grad_program(fluid, op, arrays, attrs, outs, cots):
    """One `op` over data variables (float ones with gradients) and the
    loss sum(out * cot) over its outputs: (main, the float inputs' names,
    their gradient variables)."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        helper = fluid.layer_helper.LayerHelper(op)
        ins, floats = {}, []
        for slot, arrs in arrays.items():
            ins[slot] = []
            for j, a in enumerate(arrs):
                v = L.data(name="%s_%d" % (slot.lower(), j),
                           shape=list(a.shape), dtype=str(a.dtype),
                           append_batch_size=False)
                v.stop_gradient = a.dtype.kind != "f"
                if a.dtype.kind == "f":
                    floats.append(v)
                ins[slot].append(v)
        out_vars = {s: [helper.create_variable_for_type_inference("float32")
                        for _ in range(n)] for s, n in outs.items()}
        helper.append_op(type=op, inputs=ins, outputs=out_vars, attrs=attrs)
        terms = []
        for s, vs in out_vars.items():
            for j, v in enumerate(vs):
                c = L.data(name="cot_%s_%d" % (s.lower(), j),
                           shape=list(cots[(s, j)].shape), dtype="float32",
                           append_batch_size=False)
                terms.append(L.reduce_sum(L.elementwise_mul(v, c)))
        loss = L.sums(terms)
        grads = fluid.gradients(loss, floats)
    return main, [v.name for v in floats], grads


def _feed(arrays, cots):
    feed = {"%s_%d" % (slot.lower(), j): a
            for slot, arrs in arrays.items() for j, a in enumerate(arrs)}
    feed.update({"cot_%s_%d" % (s.lower(), j): c
                 for (s, j), c in cots.items()})
    return feed


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradient_through_grad_of_matches_jax(case):
    op, arrays, attrs, outs = CASES[case]
    shapes = _port(op, arrays, attrs)
    cots = {(s, j): _randn(*shapes[s][j].shape, seed=100 + 7 * j + len(s))
            for s, n in outs.items() for j in range(n)}
    got, want = [], []
    for fluid, into in ((tfluid, got), (jfluid, want)):
        main, names, grads = _grad_program(fluid, op, arrays, attrs, outs,
                                           cots)
        if fluid is tfluid:
            types = [o.type for o in main.global_block().ops]
            assert "grad_of" in types, types
        into.extend(fluid.Executor(fluid.CPUPlace()).run(
            main, feed=_feed(arrays, cots), fetch_list=grads,
            scope=fluid.Scope()))
    assert len(got) == len(want) > 0
    for n, g, w in zip(names, got, want):
        _check(g, w, (case, n), GRAD_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_shape_inference_gives_the_forwards_shapes(case):
    op, arrays, attrs, _ = CASES[case]
    meta = treg.infer_outputs(op, {k: [t.to("meta") for t in v]
                                   for k, v in _t(arrays).items()}, attrs)
    got = _port(op, arrays, attrs)
    for slot in got:
        for m, g in zip(meta[slot], got[slot]):
            assert (m.shape, m.dtype) == (g.shape, g.dtype), slot


# ---- each fused op against its unfused composition, on the port -------------

def _lower(op, arrays, attrs):
    return _port(op, arrays, attrs)


def test_fusion_lstm_is_its_projection_then_lstm():
    _, arrays, attrs, _ = CASES["fusion_lstm"]
    got = _lower("fusion_lstm", arrays, attrs)
    xx = np.einsum("btm,mh->bth", arrays["X"][0], arrays["WeightX"][0])
    sub = {k: v for k, v in arrays.items() if k not in ("X", "WeightX")}
    sub["Weight"] = sub.pop("WeightH")
    want = _lower("lstm", dict(sub, Input=[xx.astype(np.float32)]), attrs)
    _check(got["Hidden"][0], want["Hidden"][0], "Hidden")
    _check(got["Cell"][0], want["Cell"][0], "Cell")


def test_fusion_gru_is_its_projection_then_gru():
    _, arrays, attrs, _ = CASES["fusion_gru"]
    got = _lower("fusion_gru", arrays, attrs)
    xx = np.einsum("btm,mh->bth", arrays["X"][0], arrays["WeightX"][0])
    sub = {"Input": [xx.astype(np.float32)], "Weight": arrays["WeightH"],
           "Bias": arrays["Bias"], "Length": arrays["Length"]}
    _check(got["Hidden"][0], _lower("gru", sub, attrs)["Hidden"][0], "gru")


def test_fused_embedding_fc_lstm_is_the_folded_lookup():
    """Embeddings = W_emb · W_x: the fused lookup is fusion_lstm on the
    embedded ids."""
    r = np.random.RandomState(5)
    emb, wx = r.randn(7, 3).astype(np.float32), r.randn(3, 8).astype(
        np.float32)
    _, arrays, attrs, _ = CASES["fused_embedding_fc_lstm"]
    arrays = dict(arrays, Embeddings=[emb @ wx])
    got = _lower("fused_embedding_fc_lstm", arrays, attrs)
    x = emb[arrays["Ids"][0][..., 0]]
    want = _lower("fusion_lstm", {
        "X": [x], "WeightX": [wx], "WeightH": arrays["WeightH"],
        "Bias": arrays["Bias"], "Length": arrays["Length"]}, attrs)
    _check(got["Hidden"][0], want["Hidden"][0], "Hidden")


def test_fused_embedding_seq_pool_is_lookup_then_sum_pool():
    _, arrays, attrs, _ = CASES["fused_embedding_seq_pool"]
    got = _lower("fused_embedding_seq_pool", arrays, attrs)["Out"][0]
    rows = arrays["W"][0][arrays["Ids"][0]]
    want = _lower("sequence_pool", {"X": [rows], "Length": arrays["Length"]},
                  {"pooltype": "SUM"})["Out"][0]
    _check(got, want, "pool")


def test_fusion_seqconv_eltadd_relu_is_conv_bias_relu():
    _, arrays, attrs, _ = CASES["fusion_seqconv_eltadd_relu"]
    got = _lower("fusion_seqconv_eltadd_relu", arrays, attrs)["Out"][0]
    conv = _lower("sequence_conv", {"X": arrays["X"],
                                    "Filter": arrays["Filter"],
                                    "Length": arrays["Length"]},
                  attrs)["Out"][0].numpy()
    _check(got, np.maximum(conv + arrays["Bias"][0], 0), "seqconv")


def test_fusion_seqexpand_concat_fc_broadcasts_then_fc():
    _, arrays, attrs, _ = CASES["fusion_seqexpand_concat_fc"]
    got = _lower("fusion_seqexpand_concat_fc", arrays, attrs)["Out"][0]
    base, a, b = arrays["X"]
    t = base.shape[1]
    cat = np.concatenate([base, np.repeat(a[:, None], t, 1),
                          np.repeat(b[:, None], t, 1)], -1)
    _check(got, np.tanh(cat @ arrays["FCWeight"][0] + arrays["FCBias"][0]),
           "fc")


def test_fusion_seqpool_concat_is_pools_concatenated():
    _, arrays, attrs, _ = CASES["fusion_seqpool_concat"]
    got = _lower("fusion_seqpool_concat", arrays, attrs)["Out"][0]
    pools = [_lower("sequence_pool", {"X": [x], "Length": [n]},
                    {"pooltype": "SUM"})["Out"][0].numpy()
             for x, n in zip(arrays["X"], arrays["Length"])]
    _check(got, np.concatenate(pools, 1), "concat")


def test_fusion_squared_mat_sub_is_the_fm_term():
    _, arrays, attrs, _ = CASES["fusion_squared_mat_sub"]
    x, y = arrays["X"][0].astype(np.float64), arrays["Y"][0].astype(
        np.float64)
    got = _lower("fusion_squared_mat_sub", arrays, attrs)["Out"][0]
    _check(got, 0.5 * ((x @ y) ** 2 - (x * x) @ (y * y)), "fm")


def test_fusion_repeated_fc_relu_is_fc_relu_chain():
    _, arrays, attrs, _ = CASES["fusion_repeated_fc_relu"]
    got = _lower("fusion_repeated_fc_relu", arrays, attrs)
    h = arrays["X"][0].reshape(4, -1)
    relus = []
    for w, b in zip(arrays["W"], arrays["Bias"]):
        h = np.maximum(h @ w + b, 0)
        relus.append(h)
    _check(got["Out"][0], relus[-1], "Out")
    for g, want in zip(got["ReluOut"], relus[:-1]):
        _check(g, want, "ReluOut")


def test_fusion_transpose_flatten_concat_is_three_ops():
    _, arrays, attrs, _ = CASES["fusion_transpose_flatten_concat"]
    got = _lower("fusion_transpose_flatten_concat", arrays, attrs)["Out"][0]
    want = np.concatenate([x.transpose(0, 2, 3, 1).reshape(2, -1)
                           for x in arrays["X"]], 1)
    _check(got, want, "concat")


def test_conv2d_fusion_is_conv_bias_residual_relu():
    _, arrays, attrs, _ = CASES["conv2d_fusion"]
    got = _lower("conv2d_fusion", arrays, attrs)["Output"][0]
    conv = _lower("conv2d", {"Input": arrays["Input"],
                             "Filter": arrays["Filter"]},
                  attrs)["Output"][0].numpy()
    want = np.maximum(conv + arrays["Bias"][0].reshape(1, -1, 1, 1) +
                      arrays["ResidualData"][0], 0)
    _check(got, want, "conv")


def test_conv2d_inception_fusion_is_four_padded_convs():
    _, arrays, attrs, _ = CASES["conv2d_inception_fusion"]
    got = _lower("conv2d_inception_fusion", arrays, attrs)["Output"][0]
    outs = []
    for f, b in zip(arrays["Filter"], arrays["Bias"]):
        p = (f.shape[2] - 1) // 2
        o = _lower("conv2d", {"Input": arrays["Input"], "Filter": [f]},
                   {"strides": [1, 1], "paddings": [p, p],
                    "dilations": [1, 1], "groups": 1})["Output"][0].numpy()
        outs.append(np.maximum(o + b.reshape(1, -1, 1, 1), 0))
    _check(got, np.concatenate(outs, 1), "inception")


def _attention_lstm_numpy(arrays):
    """attention_lstm_op.cc's steps in float64 numpy: AttentionWeight x
    rows first, LSTMWeight hidden rows first, gates [f, i, o, c~]."""
    x = arrays["X"][0].astype(np.float64)
    c = arrays["C0"][0].astype(np.float64)
    h = arrays["H0"][0].astype(np.float64)
    aw, lw = arrays["AttentionWeight"][0], arrays["LSTMWeight"][0]
    ab = float(arrays["AttentionBias"][0].reshape(-1)[0])
    sc = float(arrays["AttentionScalar"][0].reshape(-1)[0])
    sb = float(arrays["AttentionScalarBias"][0].reshape(-1)[0])
    lb = arrays["LSTMBias"][0].reshape(-1)
    lens = arrays["Length"][0]
    b, t, m = x.shape
    d = c.shape[1]

    def sig(v):
        return 1 / (1 + np.exp(-v))
    hs = np.zeros((b, t, d))
    for k in range(t):
        s = np.maximum(x @ aw[:m, 0] + ab + (c @ aw[m:])[:, :1], 0)
        s = np.maximum(s * sc + sb, 0)
        s = np.where(np.arange(t)[None] < lens[:, None], s, -np.inf)
        a = np.exp(s - s.max(1, keepdims=True))
        a = a / a.sum(1, keepdims=True)
        ctx = np.einsum("bt,btm->bm", a, x)
        g = ctx @ lw[d:] + h @ lw[:d] + lb
        f, i, o = sig(g[:, :d]), sig(g[:, d:2 * d]), sig(g[:, 2 * d:3 * d])
        cn = f * c + i * np.tanh(g[:, 3 * d:])
        hn = o * np.tanh(cn)
        alive = (k < lens)[:, None]
        h, c = np.where(alive, hn, h), np.where(alive, cn, c)
        hs[:, k] = h
    return hs


def test_attention_lstm_is_the_reference_steps():
    _, arrays, attrs, _ = CASES["attention_lstm"]
    got = _lower("attention_lstm", arrays, attrs)["Hidden"][0]
    _check(got, _attention_lstm_numpy(arrays), "Hidden")


# ---- the JAX values the port keeps (ROADMAP Queue 3) ------------------------

def test_take_rows_wrap_negative_ids_and_nan_past_the_end():
    """jnp.take's default mode in both packages: -1 is the last row, an id
    before -V (or past the end) a NaN row; a NaN row past the Length stays
    NaN (NaN times the mask's 0)."""
    w = _randn(4, 2, seed=90)
    arrays = {"W": [w], "Ids": [np.array([[-1, 0, 2], [2, -5, 1]], np.int64)],
              "Length": [_lens(3, 3)]}
    for out in (_port("fused_embedding_seq_pool", arrays, {}),
                _jax("fused_embedding_seq_pool", arrays, {})):
        out = _np(out["Out"][0])
        np.testing.assert_allclose(out[0], w[-1] + w[0] + w[2], rtol=1e-5)
        assert np.isnan(out[1]).all()
    arrays = {"W": [w], "Ids": [np.array([[1, 4, 0]], np.int64)],
              "Length": [_lens(1)]}
    got = _np(_port("fused_embedding_seq_pool", arrays, {})["Out"][0])
    want = _np(_jax("fused_embedding_seq_pool", arrays, {})["Out"][0])
    assert np.isnan(got).all() and np.isnan(want).all()


def test_fused_embedding_fc_lstm_takes_negative_and_past_end_ids():
    w = _randn(5, 4, seed=93)
    arrays = {"Ids": [np.array([[-1, 5]], np.int64)], "Embeddings": [w],
              "WeightH": [_randn(1, 4, seed=94)]}
    got = _np(_port("fused_embedding_fc_lstm", arrays, {})["XX"][0])
    want = _np(_jax("fused_embedding_fc_lstm", arrays, {})["XX"][0])
    np.testing.assert_allclose(got[0, 0], w[-1], rtol=1e-6)
    assert np.isnan(got[0, 1]).all() and np.isnan(want[0, 1]).all()
    np.testing.assert_allclose(got[0, 0], want[0, 0], rtol=1e-6)


def test_attention_lstm_row_of_length_zero_is_nan_in_both_packages():
    _, arrays, attrs, _ = CASES["attention_lstm"]
    arrays = dict(arrays, Length=[_lens(4, 0, 3)])
    got = _np(_port("attention_lstm", arrays, attrs)["Hidden"][0])
    want = _np(_jax("attention_lstm", arrays, attrs)["Hidden"][0])
    assert np.isnan(got[1]).all() and np.isnan(want[1]).all()
    assert np.isfinite(got[[0, 2]]).all()
    _check(got[[0, 2]], want[[0, 2]], "live rows")


def test_inception_fusion_even_filter_raises_in_both_packages():
    """The four filters all read the input, padded (k - 1) // 2: a 2 x 2
    filter gives a smaller map, and the concat raises."""
    _, arrays, attrs, _ = CASES["conv2d_inception_fusion"]
    arrays = dict(arrays, Filter=[arrays["Filter"][0],
                                  _randn(3, 3, 2, 2, seed=95)] +
                  arrays["Filter"][2:])
    with pytest.raises(Exception):
        _port("conv2d_inception_fusion", arrays, attrs)
    with pytest.raises(Exception):
        _jax("conv2d_inception_fusion", arrays, attrs)


@pytest.mark.parametrize("act", ["relu6", "leaky_relu"])
def test_conv2d_fusion_activation_outside_its_table_raises_keyerror(act):
    _, arrays, attrs, _ = CASES["conv2d_fusion"]
    attrs = dict(attrs, activation=act)
    with pytest.raises(KeyError):
        _port("conv2d_fusion", arrays, attrs)
    with pytest.raises(KeyError):
        _jax("conv2d_fusion", arrays, attrs)
