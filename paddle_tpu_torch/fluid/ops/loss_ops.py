"""Loss lowerings: softmax_with_cross_entropy and its grad, and
sigmoid_cross_entropy_with_logits (the port's counterpart of
``paddle_tpu/fluid/ops/loss_ops.py``). With FLAGS_ce_kernel
(off by default, as in the JAX package) both directions take the CUDA
cross-entropy kernels (ops/ce_kernel.py) on the card where the JAX gate
admits the shape; otherwise they are plain PyTorch.

The ``Softmax`` output is a full f32 [tokens, V] tensor that a training
program never reads. XLA's dead-code elimination drops it in the JAX
package; here the lowering computes it only when the executor's plan says
a later op or a fetch reads it, or that it is persistable
(``ctx.output_live``)."""
import math

import torch

from . import common
from .registry import register_lowering, register_grad_maker
from .common import one


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
    grad_of's."""
    x, label = one(inputs, "X"), one(inputs, "Label")
    ignore = attrs.get("ignore_index", -100)
    loss = torch.clamp(x, min=0) - x * label + \
        torch.log1p(torch.exp(-torch.abs(x)))
    keep = label != ignore
    loss = torch.where(keep, loss, torch.zeros_like(loss))
    if attrs.get("normalize", False):
        loss = loss / torch.clamp(torch.sum(keep.to(x.dtype)), min=1.0)
    return {"Out": [loss]}
