"""Loss lowerings: softmax_with_cross_entropy and its grad,
sigmoid_cross_entropy_with_logits, and the Fluid losses: cross_entropy
(over probabilities) and cross_entropy2, bpr, log, Huber, smooth L1,
hinge, rank, margin-rank, modified Huber, teacher-student, KL and n-pair
(the port's counterpart of ``paddle_tpu/fluid/ops/loss_ops.py``). With
FLAGS_ce_kernel (off by default, as in the JAX package) both directions
of softmax_with_cross_entropy take the CUDA cross-entropy kernels
(ops/ce_kernel.py) on the card where the JAX gate admits the shape;
otherwise they are plain PyTorch.

The ``Softmax`` output is a full f32 [tokens, V] tensor that a training
program never reads. XLA's dead-code elimination drops it in the JAX
package; here the lowering computes it only when the executor's plan says
a later op or a fetch reads it, or that it is persistable
(``ctx.output_live``)."""
import math

import torch

from . import common
from .registry import register_lowering, register_grad_maker
from .common import one, jnp_abs as _abs


def _hard_label(label, v, ignore):
    """(flat int64 label, mask of ignored or out-of-range rows)."""
    flat = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 else label
    flat = flat.long()
    return flat, (flat == ignore) | (flat < 0) | (flat >= v)


def _ce_kernel_ok(logits, soft):
    """The JAX package's gate (``_ce_pallas_ok``): the flag, hard labels,
    the tensors on the card, and ``ce_ok`` on the flat [tokens, V] shape."""
    from ...ops.ce_kernel import ce_ok
    from .. import flags
    if not flags.get("ce_kernel"):
        return False
    if soft or not common.on_card(logits):
        return False
    return ce_ok(math.prod(logits.shape[:-1]), int(logits.shape[-1]),
                 logits.element_size())


def _flat(logits, label):
    """[tokens, V] logits and [tokens] int64 labels."""
    return (logits.reshape(-1, logits.shape[-1]).contiguous(),
            label.reshape(-1).long().contiguous())


@register_lowering("softmax_with_cross_entropy")
def _softmax_with_cross_entropy(ctx, inputs, attrs):
    """Reduced in f32 via logsumexp; a hard label outside [0, V) or equal
    to ignore_index gives loss 0, as in the JAX lowering."""
    logits, label = one(inputs, "Logits"), one(inputs, "Label")
    soft = attrs.get("soft_label", False)
    ignore = attrs.get("ignore_index", -100)
    if _ce_kernel_ok(logits, soft):
        from ...ops.ce_kernel import ce_forward
        lead = tuple(logits.shape[:-1])
        loss_f, lse_f = ce_forward(*_flat(logits, label), ignore=ignore)
        lse = lse_f.reshape(lead + (1,))
        out = {"Loss": [loss_f.reshape(lead + (1,))], "LSE": [lse]}
        if ctx.output_live("Softmax"):
            out["Softmax"] = [torch.exp(logits.float() - lse)]
        return out
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1, keepdim=True)
    if soft:
        loss = torch.sum(label * (lse - lf), dim=-1, keepdim=True)
    else:
        v = logits.shape[-1]
        flat, masked = _hard_label(label, v, ignore)
        picked = torch.gather(lf, -1, flat.clamp(0, v - 1)[..., None])
        loss = torch.where(masked[..., None], torch.zeros_like(lse),
                           lse - picked)
    out = {"Loss": [loss], "LSE": [lse]}
    if ctx.output_live("Softmax"):
        out["Softmax"] = [torch.exp(lf - lse)]
    return out


@register_grad_maker("softmax_with_cross_entropy", wants_og=True)
def _softmax_ce_grad_maker(op, block, no_grad_set, og_avail=()):
    """dlogits in the logits dtype from the saved LSE; only the Loss output
    is differentiable."""
    logits = op.input("Logits")[0]
    label = op.input("Label")[0]
    loss_out = op.output("Loss")[0]
    if op.output("Softmax") and op.output("Softmax")[0] in og_avail:
        raise NotImplementedError(
            "softmax_with_cross_entropy: gradient flows into the Softmax "
            "output; only the Loss output is differentiable")
    lse = op.output("LSE")
    grad_op = {
        "type": "softmax_with_cross_entropy_grad",
        "inputs": {"Logits": [logits], "Label": [label],
                   "LSE": lse or ["@EMPTY@"],
                   "Loss@GRAD": [loss_out + "@GRAD"]},
        "outputs": {"Logits@GRAD": [logits + "@GRAD"]},
        "attrs": dict(op.attrs),
    }
    return [grad_op], {logits + "@GRAD": logits}


@register_lowering("softmax_with_cross_entropy_grad", no_grad=True)
def _softmax_ce_grad(ctx, inputs, attrs):
    """dlogits = (exp(l - lse) - onehot) * dloss in f32, ignored rows
    zeroed, written in the logits dtype: the CUDA backward kernel where the
    forward's gate admits the shape, plain PyTorch otherwise."""
    logits = one(inputs, "Logits")
    label = one(inputs, "Label")
    lse = one(inputs, "LSE")
    dloss = one(inputs, "Loss@GRAD")
    soft = attrs.get("soft_label", False)
    ignore = attrs.get("ignore_index", -100)
    if lse is not None and _ce_kernel_ok(logits, soft):
        from ...ops.ce_kernel import ce_backward
        lead = tuple(logits.shape[:-1])
        g = torch.broadcast_to(dloss, lead + (1,)).reshape(-1).float()
        dl = ce_backward(*_flat(logits, label),
                         lse.reshape(-1).float().contiguous(),
                         g.contiguous(), ignore=ignore)
        return {"Logits@GRAD": [dl.reshape(logits.shape)]}
    lf = logits.float()
    if lse is None:
        lse = torch.logsumexp(lf, dim=-1, keepdim=True)
    g = torch.broadcast_to(dloss, lse.shape).float()
    if soft:
        dlogits = (torch.exp(lf - lse) - label.float()) * g
        return {"Logits@GRAD": [dlogits.to(logits.dtype)]}
    v = logits.shape[-1]
    flat, masked = _hard_label(label, v, ignore)
    g = torch.where(masked[..., None], torch.zeros_like(g), g)
    onehot = torch.arange(v, device=logits.device) == flat[..., None]
    dlogits = (torch.exp(lf - lse) - onehot.float()) * g
    return {"Logits@GRAD": [dlogits.to(logits.dtype)]}


@register_lowering("sigmoid_cross_entropy_with_logits")
def _sigmoid_ce(ctx, inputs, attrs):
    """max(x, 0) - x*label + log1p(exp(-|x|)) elementwise in x's dtype;
    an element whose label equals ignore_index gives 0, and ``normalize``
    divides by the count of the others (at least 1). The gradient is
    grad_of's, at x = 0 the JAX formula's (the maximum's tie split,
    _abs's slope 1): -label."""
    x, label = one(inputs, "X"), one(inputs, "Label")
    ignore = attrs.get("ignore_index", -100)
    loss = torch.maximum(x, _zero_like_scalar(x)) - x * label + \
        torch.log1p(torch.exp(-_abs(x)))
    keep = label != ignore
    loss = torch.where(keep, loss, torch.zeros_like(loss))
    if attrs.get("normalize", False):
        loss = loss / torch.clamp(torch.sum(keep.to(x.dtype)), min=1.0)
    return {"Out": [loss]}


# ---- the other Fluid losses. Each gradient is grad_of's on the taped
# forward, as the JAX package's comes from jax.vjp of its lowering.

def _take_label(x, label):
    """``jnp.take_along_axis(x, label[..., None], axis=-1)`` in its default
    mode: a negative label wraps once by +classes; one still outside
    [0, classes) picks NaN, and no gradient reaches x through it."""
    v = x.shape[-1]
    idx = torch.where(label < 0, label + v, label)
    valid = (idx >= 0) & (idx < v)
    picked = torch.gather(x, -1, idx.clamp(0, v - 1)[..., None])
    return torch.where(valid[..., None], picked,
                       torch.full((), float("nan"), dtype=x.dtype,
                                  device=x.device))


def _zero_like_scalar(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


@register_lowering("cross_entropy")
def _cross_entropy(ctx, inputs, attrs):
    """-log(x[label] + 1e-12) over probabilities x (hard labels) or
    -sum(label * log(x + 1e-12)) (soft). A hard label equal to
    ignore_index gives 0; a negative one wraps once; one still outside the
    classes gives NaN, as the JAX lowering's gather fills it (_take_label).
    Neither passes a gradient to x."""
    x, label = one(inputs, "X"), one(inputs, "Label")
    eps = 1e-12
    if attrs.get("soft_label", False):
        return {"Y": [-torch.sum(label * torch.log(x + eps), dim=-1,
                                 keepdim=True)]}
    ignore = attrs.get("ignore_index", -100)
    flat = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 else label
    flat = flat.long()
    loss = -torch.log(_take_label(x, flat) + eps)
    return {"Y": [torch.where(flat[..., None] == ignore,
                              _zero_like_scalar(loss), loss)]}


@register_lowering("cross_entropy2")
def _cross_entropy2(ctx, inputs, attrs):
    """cross_entropy's Y, with XShape (zeros of shape (0,) + x.shape) and
    MatchX = exp(-Y)."""
    y = _cross_entropy(ctx, inputs, attrs)["Y"][0]
    x = one(inputs, "X")
    return {"Y": [y], "XShape": [x.new_zeros((0,) + tuple(x.shape))],
            "MatchX": [torch.exp(-y)]}


@register_lowering("bpr_loss")
def _bpr_loss(ctx, inputs, attrs):
    """-mean(log(sigmoid(x[label] - x) + 1e-12)) over each row; the label
    picked as cross_entropy picks it (NaN outside the classes)."""
    x, label = one(inputs, "X"), one(inputs, "Label")
    diff = _take_label(x, label.reshape(-1).long()) - x
    return {"Y": [-torch.mean(torch.log(torch.sigmoid(diff) + 1e-12),
                              dim=-1, keepdim=True)]}


@register_lowering("log_loss")
def _log_loss(ctx, inputs, attrs):
    pred, label = one(inputs, "Predicted"), one(inputs, "Labels")
    eps = attrs.get("epsilon", 1e-4)
    return {"Loss": [-label * torch.log(pred + eps) -
                     (1 - label) * torch.log(1 - pred + eps)]}


@register_lowering("huber_loss")
def _huber_loss(ctx, inputs, attrs):
    x, y = one(inputs, "X"), one(inputs, "Y")
    delta = attrs.get("delta", 1.0)
    r = y - x
    ar = torch.abs(r)
    loss = torch.where(ar <= delta, 0.5 * r * r, delta * (ar - 0.5 * delta))
    return {"Out": [loss], "Residual": [r]}


@register_lowering("smooth_l1_loss")
def _smooth_l1_loss(ctx, inputs, attrs):
    """Per-sample sums [N, 1] of the smooth L1 of (x - y) * InsideWeight,
    each element times OutsideWeight (both optional)."""
    x, y = one(inputs, "X"), one(inputs, "Y")
    sigma = attrs.get("sigma", 1.0)
    in_w = one(inputs, "InsideWeight")
    out_w = one(inputs, "OutsideWeight")
    diff = x - y
    if in_w is not None:
        diff = diff * in_w
    s2 = sigma * sigma
    ad = torch.abs(diff)
    elem = torch.where(ad < 1.0 / s2, 0.5 * s2 * diff * diff, ad - 0.5 / s2)
    if out_w is not None:
        elem = elem * out_w
    loss = torch.sum(elem, dim=tuple(range(1, x.ndim))).reshape(x.shape[0], 1)
    return {"Diff": [diff], "Out": [loss]}


@register_lowering("hinge_loss")
def _hinge_loss(ctx, inputs, attrs):
    """max(1 - (2 label - 1) * logits, 0); at 0 the gradient is split, as
    ``jnp.maximum`` splits it."""
    logits, label = one(inputs, "Logits"), one(inputs, "Labels")
    z = 1.0 - (2.0 * label - 1.0) * logits
    return {"Loss": [torch.maximum(z, _zero_like_scalar(z))]}


@register_lowering("rank_loss")
def _rank_loss(ctx, inputs, attrs):
    label = one(inputs, "Label")
    d = one(inputs, "Left") - one(inputs, "Right")
    return {"Out": [torch.log1p(torch.exp(d)) - label * d]}


@register_lowering("margin_rank_loss")
def _margin_rank_loss(ctx, inputs, attrs):
    """max(-label * (x1 - x2) + margin, 0), its tie split as in
    hinge_loss; Activated marks where it is positive."""
    label = one(inputs, "Label")
    x1, x2 = one(inputs, "X1"), one(inputs, "X2")
    z = -label * (x1 - x2) + attrs.get("margin", 0.0)
    out = torch.maximum(z, _zero_like_scalar(z))
    return {"Out": [out], "Activated": [(out > 0).to(x1.dtype)]}


@register_lowering("modified_huber_loss")
def _modified_huber_loss(ctx, inputs, attrs):
    x, y = one(inputs, "X"), one(inputs, "Y")
    z = (2.0 * y - 1.0) * x
    loss = torch.where(z >= 1.0, torch.zeros_like(z),
                       torch.where(z >= -1.0, torch.square(1.0 - z),
                                   -4.0 * z))
    return {"IntermediateVal": [z], "Out": [loss]}


@register_lowering("teacher_student_sigmoid_loss")
def _ts_sigmoid_loss(ctx, inputs, attrs):
    """The sigmoid cross-entropy of x clipped to [soft_max_lower_bound,
    soft_max_up_bound] as ``jnp.clip`` clips (minimum of maximum: a
    gradient at a bound is split); at 0 the gradient is the JAX
    formula's (_abs)."""
    x, label = one(inputs, "X"), one(inputs, "Label")
    z = torch.minimum(
        torch.maximum(x, x.new_tensor(attrs.get("soft_max_lower_bound",
                                                -15.0))),
        x.new_tensor(attrs.get("soft_max_up_bound", 15.0)))
    loss = torch.maximum(z, _zero_like_scalar(z)) - z * label + \
        torch.log1p(torch.exp(-_abs(z)))
    return {"Y": [loss]}


@register_lowering("kldiv_loss")
def _kldiv_loss(ctx, inputs, attrs):
    """target * (log(target + 1e-12) - x), reduced by ``reduction``: "mean"
    (the default), "sum", "batchmean" (the sum over the batch size) or
    "none"."""
    x, target = one(inputs, "X"), one(inputs, "Target")
    loss = target * (torch.log(target + 1e-12) - x)
    red = attrs.get("reduction", "mean")
    if red == "mean":
        loss = torch.mean(loss)
    elif red == "sum":
        loss = torch.sum(loss)
    elif red == "batchmean":
        loss = torch.sum(loss) / x.shape[0]
    return {"Loss": [loss]}


@register_lowering("npair_loss")
def _npair_loss(ctx, inputs, attrs):
    """The mean softmax cross-entropy of anchor @ positive.T against the
    row-normalised label-equality targets, plus l2_reg times the squared
    norms of both over 2 * batch."""
    anchor, positive = one(inputs, "Anchor"), one(inputs, "Positive")
    labels = one(inputs, "Labels")
    l2_reg = attrs.get("l2_reg", 0.002)
    batch = anchor.shape[0]
    sim = torch.matmul(anchor, positive.T)
    targets = (labels[:, None] == labels[None, :]).to(anchor.dtype)
    targets = targets / torch.sum(targets, dim=1, keepdim=True)
    ce = torch.mean(torch.sum(-targets * torch.log_softmax(sim, dim=1),
                              dim=1))
    l2 = l2_reg * (torch.sum(torch.square(anchor)) +
                   torch.sum(torch.square(positive))) / (2.0 * batch)
    return {"Out": [ce + l2]}
