"""Decoding and structured-prediction lowerings: the port's counterpart of
``paddle_tpu/fluid/ops/decode_ops.py``, all 6 of its lowerings (beam
search, the backtrack over its steps, the linear-chain CRF with its grad
op, Viterbi decoding, NCE), with the JAX lowerings' semantics (reference:
operators/beam_search_op.*, math/beam_search.*, linear_chain_crf_op.*,
crf_decoding_op.*, nce_op.*).

Where a JAX lowering scans over time (``lax.scan``), these run a Python
loop over T on the device: no value is read back to the host, so a
decode step or a CRF costs launches and no sync. The CRF and Viterbi
compute in float32, as the JAX lowerings cast.

Ties: ``beam_search`` orders equal scores lower index first, as
``jax.lax.top_k`` does (``common.top_k``; ``torch.topk`` promises no order
among ties); Viterbi's ``argmax`` takes the first maximum, as
``jnp.argmax`` does.

Differences from the Paddle reference that the JAX lowerings have and the
port keeps (ROADMAP Queue 3): ``beam_search`` adds ``pre_scores`` to
``scores`` that are already accumulated, and its layer does not pass
``ids``, so a selected id is a position in the scores' row; the CRF's
LogLikelihood is path - logZ (<= 0), where the reference's op returns
the negative log-likelihood; the Viterbi path is the best path shifted
one step earlier, its last tag repeated (the JAX backtrack emits the tag
of step t + 1 at step t).

NCE draws its ``num_neg_samples`` uniform negatives a row from a
``torch.Generator`` on the op's device seeded by (``seed``, batch), as the
JAX lowering draws from ``fold_in(PRNGKey(seed), batch)``: the same
negatives on every call with the same seed and batch, other numbers than
threefry's. Its gradient comes from the executor's ``grad_of``; the rows
of W and Bias it picks add their gradients in batch order
(``tensor_ops._Gather``).
"""
import math

import torch
import torch.nn.functional as F

from .common import one, top_k
from .registry import register_grad_maker, register_lowering
from .tensor_ops import _Gather, take_rows


# ---------- beam search ----------

@register_lowering("beam_search", no_grad=True)
def _beam_search(ctx, inputs, attrs):
    """One decode step: scores [B*W, V] plus pre_scores [B*W, 1], each
    source's W rows as one group of W*V candidates, the top beam_size of
    each group. selected_ids [B*W, 1] (the position modulo V),
    selected_scores [B*W, 1], parent_idx [B*W] (the global row each came
    from); int64 ids."""
    pre_scores = one(inputs, "pre_scores")
    scores = one(inputs, "scores")
    beam = attrs["beam_size"]
    bw, v = scores.shape
    b = bw // beam
    grouped = (scores + pre_scores).reshape(b, beam * v)
    top_val, top_idx = top_k(grouped, beam)
    parent = top_idx // v + torch.arange(b, device=scores.device)[:, None] \
        * beam
    return {"selected_ids": [(top_idx % v).reshape(-1, 1)],
            "selected_scores": [top_val.reshape(-1, 1)],
            "parent_idx": [parent.reshape(-1)]}


@register_lowering("beam_search_decode", no_grad=True)
def _beam_search_decode(ctx, inputs, attrs):
    """The hypotheses backtracked from the steps' Ids [T, B*W, 1] and
    ParentIdx [T, B*W], from the last step to the first: SentenceIds
    [B*W, T] int64; SentenceScores the Scores as given."""
    ids = one(inputs, "Ids")
    parents = one(inputs, "ParentIdx")
    scores = one(inputs, "Scores")
    t, bw = parents.shape[0], parents.shape[1]
    ids2 = ids.reshape(t, bw)
    pos = torch.arange(bw, device=ids.device)
    toks = [None] * t
    for s in reversed(range(t)):
        toks[s] = take_rows(ids2[s], pos)
        pos = take_rows(parents[s].long(), pos)
    return {"SentenceIds": [torch.stack(toks, dim=1).long()],
            "SentenceScores": [scores]}


# ---------- linear-chain CRF ----------

def _lengths(length, b, t, device):
    """Each row's length as int64 [B] (T for every row without Length)."""
    if length is None:
        return torch.full((b,), t, dtype=torch.int64, device=device)
    return length.reshape(-1).long()


def _one_hot(label, n, dtype):
    """label [B, T] as [B, T, n]; a label outside [0, n) a row of zeros
    (no host check, unlike F.one_hot)."""
    return (label[..., None] == torch.arange(n, device=label.device)) \
        .to(dtype)


def crf_log_z(emission, transition, lens):
    """The forward algorithm over emission [B, T, n] (float32): log Z [B].
    Transition rows: [0] start, [1] stop, [2:] from -> to. alpha holds past
    a row's length."""
    trans = transition[2:]
    alpha = transition[0] + emission[:, 0]
    for t in range(1, emission.shape[1]):
        new = torch.logsumexp(alpha[:, :, None] + trans, dim=1) + \
            emission[:, t]
        alpha = torch.where((t < lens)[:, None], new, alpha)
    return torch.logsumexp(alpha + transition[1], dim=1)


def crf_path_score(emission, transition, label, lens):
    """The score of the label path [B, T] over each row's length: start,
    emissions, transitions and stop at the row's last label (label[0] for
    a row of length 0), as dense one-hot sums (no scatter in the
    gradient)."""
    b, t, n = emission.shape
    hot = _one_hot(label, n, emission.dtype)
    live = (torch.arange(t, device=emission.device)[None, :] <
            lens[:, None]).to(emission.dtype)
    emit = (emission * hot).sum(2)
    trans = torch.einsum("bti,ij,btj->b", hot[:, :-1] * live[:, 1:, None],
                         transition[2:], hot[:, 1:])
    last = torch.gather(hot, 1, (lens - 1).clamp(min=0)[:, None, None]
                        .expand(b, 1, n))[:, 0]
    return hot[:, 0] @ transition[0] + (emit * live).sum(1) + trans + \
        last @ transition[1]


def _crf_operands(inputs):
    emission = one(inputs, "Emission")
    b, t = emission.shape[0], emission.shape[1]
    label = one(inputs, "Label").reshape(b, t).long()
    lens = _lengths(one(inputs, "Length"), b, t, emission.device)
    return emission, one(inputs, "Transition"), label, lens


def crf_log_likelihood(emission, transition, label, lens):
    """path - logZ [B] in float32 (the JAX lowering's sign)."""
    e, tr = emission.float(), transition.float()
    return crf_path_score(e, tr, label, lens) - crf_log_z(e, tr, lens)


@register_lowering("linear_chain_crf")
def _linear_chain_crf(ctx, inputs, attrs):
    """LogLikelihood [B, 1] = path - logZ over padded emissions [B, T, n]
    and Label [B, T(, 1)], Length optional; Alpha zeros like Emission,
    EmissionExps and TransitionExps the exps."""
    emission, transition, label, lens = _crf_operands(inputs)
    ll = crf_log_likelihood(emission, transition, label, lens)
    return {"LogLikelihood": [ll.reshape(-1, 1)],
            "Alpha": [torch.zeros_like(emission)],
            "EmissionExps": [torch.exp(emission)],
            "TransitionExps": [torch.exp(transition)]}


@register_grad_maker("linear_chain_crf")
def _crf_grad_maker(op, block, no_grad_set):
    """The JAX package's maker: one linear_chain_crf_grad op, gradients to
    Emission and Transition."""
    out = op.output("LogLikelihood")[0]
    grad_op = {
        "type": "linear_chain_crf_grad",
        "inputs": {"Emission": op.input("Emission"),
                   "Transition": op.input("Transition"),
                   "Label": op.input("Label"),
                   "Length": op.input("Length"),
                   "LL@GRAD": [out + "@GRAD"]},
        "outputs": {"Emission@GRAD": [op.input("Emission")[0] + "@GRAD"],
                    "Transition@GRAD": [op.input("Transition")[0] + "@GRAD"]},
        "attrs": dict(op.attrs),
    }
    return [grad_op], {op.input("Emission")[0] + "@GRAD":
                       op.input("Emission")[0],
                       op.input("Transition")[0] + "@GRAD":
                       op.input("Transition")[0]}


@register_lowering("linear_chain_crf_grad")
def _linear_chain_crf_grad(ctx, inputs, attrs):
    """The gradients of sum(LL@GRAD * LogLikelihood) by autograd over the
    forward in float32, each in its input's dtype."""
    emission, transition, label, lens = _crf_operands(inputs)
    cot = one(inputs, "LL@GRAD").reshape(-1).float().expand(
        emission.shape[0])
    with torch.enable_grad():
        e = emission.detach().float().requires_grad_(True)
        tr = transition.detach().float().requires_grad_(True)
        de, dt = torch.autograd.grad(
            crf_log_likelihood(e, tr, label, lens), (e, tr), cot)
    return {"Emission@GRAD": [de.to(emission.dtype)],
            "Transition@GRAD": [dt.to(transition.dtype)]}


def viterbi(emission, transition, lens):
    """The JAX lowering's Viterbi over emission [B, T, n] (float32): the
    back-pointers past a row's length the identity, the last tag the
    argmax of alpha + stop, then the backtrack as the JAX scan emits it:
    [B, T] int64, the tag of step t + 1 at step t and the last tag
    repeated at T - 1."""
    b, t, n = emission.shape
    trans = transition[2:]
    alpha = transition[0] + emission[:, 0]
    same = torch.arange(n, device=emission.device).expand(b, n)
    bps = []
    for ti in range(1, t):
        scores = alpha[:, :, None] + trans
        live = (ti < lens)[:, None]
        bps.append(torch.where(live, scores.argmax(dim=1), same))
        alpha = torch.where(live, scores.amax(dim=1) + emission[:, ti],
                            alpha)
    last = (alpha + transition[1]).argmax(dim=1)
    path, cur = [last] * t, last
    for ti in reversed(range(t - 1)):
        path[ti] = cur
        cur = torch.gather(bps[ti], 1, cur[:, None])[:, 0]
    return torch.stack(path, dim=1)


@register_lowering("crf_decoding", no_grad=True)
def _crf_decoding(ctx, inputs, attrs):
    """ViterbiPath [B, T] int64: the path, or with Label its 0/1 agreement
    with the label."""
    emission = one(inputs, "Emission")
    transition = one(inputs, "Transition")
    label = one(inputs, "Label")
    b, t = emission.shape[0], emission.shape[1]
    lens = _lengths(one(inputs, "Length"), b, t, emission.device)
    path = viterbi(emission.float(), transition.float(), lens)
    if label is not None:
        path = (path == label.reshape(b, t).long()).long()
    return {"ViterbiPath": [path]}


# ---------- NCE ----------

def nce_negatives(device, seed, batch, num_neg, classes):
    """[batch, num_neg] int64 classes drawn uniformly from a generator on
    `device` seeded by (seed, batch): the same draw on every call."""
    if torch.device(device).type == "meta":
        return torch.empty((batch, num_neg), dtype=torch.int64,
                           device="meta")
    gen = torch.Generator(device=device)
    # 32 bits: the CPU's generator reads no more of a seed
    gen.manual_seed((int(seed) * 2654435761 + int(batch)) % (1 << 32))
    return torch.randint(0, classes, (batch, num_neg), generator=gen,
                         device=device)


def nce_cost(pos_logit, neg_logit, classes):
    """The logistic NCE loss against uniform noise (log q = -log V):
    softplus(-(s+ - log q)) + sum softplus(s- - log q), [B, 1]."""
    log_q = -math.log(float(classes))
    return (F.softplus(-(pos_logit - log_q)) +
            F.softplus(neg_logit - log_q).sum(dim=1)).reshape(-1, 1)


def nce_forward(x, label, w, bias, neg):
    """The nce op's outputs on the negatives `neg` [B, K]."""
    b, k = neg.shape
    lab = label.reshape(-1).long()
    pos_logit = (x * _Gather.apply(w, lab)).sum(dim=1)
    neg_w = _Gather.apply(w, neg.reshape(-1)).reshape(b, k, -1)
    neg_logit = torch.einsum("bd,bkd->bk", x, neg_w)
    if bias is not None:
        col = bias.reshape(-1, 1)
        pos_logit = pos_logit + _Gather.apply(col, lab).reshape(-1)
        neg_logit = neg_logit + _Gather.apply(col, neg.reshape(-1)) \
            .reshape(b, k)
    return {"Cost": [nce_cost(pos_logit, neg_logit, w.shape[0])],
            "SampleLogits": [torch.cat([pos_logit[:, None], neg_logit],
                                       dim=1)],
            "SampleLabels": [torch.cat([lab.reshape(b, 1), neg], dim=1)]}


@register_lowering("nce")
def _nce(ctx, inputs, attrs):
    """Cost [B, 1], SampleLogits [B, 1 + K] (the label's logit, then the
    negatives'), SampleLabels [B, 1 + K] int64; K = num_neg_samples."""
    x = one(inputs, "Input")
    w = one(inputs, "Weight")
    neg = nce_negatives(x.device, attrs.get("seed", 12345) or 12345,
                        x.shape[0], attrs.get("num_neg_samples", 10),
                        w.shape[0])
    return nce_forward(x, one(inputs, "Label"), w, one(inputs, "Bias"), neg)
