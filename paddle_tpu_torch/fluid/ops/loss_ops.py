"""Loss lowerings: softmax_with_cross_entropy and its grad (the port's
counterpart of ``paddle_tpu/fluid/ops/loss_ops.py``). The CE kernels of the
JAX package sit behind FLAGS_ce_kernel, off by default, and are not ported
yet: both directions are plain PyTorch here."""
import torch

from .registry import register_lowering, register_grad_maker
from .common import one


def _hard_label(label, v, ignore):
    """(flat int64 label, mask of ignored or out-of-range rows)."""
    flat = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 else label
    flat = flat.long()
    return flat, (flat == ignore) | (flat < 0) | (flat >= v)


@register_lowering("softmax_with_cross_entropy")
def _softmax_with_cross_entropy(ctx, inputs, attrs):
    """Reduced in f32 via logsumexp; a hard label outside [0, V) or equal
    to ignore_index gives loss 0, as in the JAX lowering."""
    logits, label = one(inputs, "Logits"), one(inputs, "Label")
    ignore = attrs.get("ignore_index", -100)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1, keepdim=True)
    if attrs.get("soft_label", False):
        loss = torch.sum(label * (lse - lf), dim=-1, keepdim=True)
    else:
        v = logits.shape[-1]
        flat, masked = _hard_label(label, v, ignore)
        picked = torch.gather(lf, -1, flat.clamp(0, v - 1)[..., None])
        loss = torch.where(masked[..., None], torch.zeros_like(lse),
                           lse - picked)
    return {"Softmax": [torch.exp(lf - lse)], "Loss": [loss], "LSE": [lse]}


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
    zeroed, written in the logits dtype."""
    logits = one(inputs, "Logits")
    label = one(inputs, "Label")
    lse = one(inputs, "LSE")
    dloss = one(inputs, "Loss@GRAD")
    lf = logits.float()
    if lse is None:
        lse = torch.logsumexp(lf, dim=-1, keepdim=True)
    g = torch.broadcast_to(dloss, lse.shape).float()
    if attrs.get("soft_label", False):
        dlogits = (torch.exp(lf - lse) - label.float()) * g
        return {"Logits@GRAD": [dlogits.to(logits.dtype)]}
    v = logits.shape[-1]
    flat, masked = _hard_label(label, v, attrs.get("ignore_index", -100))
    g = torch.where(masked[..., None], torch.zeros_like(g), g)
    onehot = torch.arange(v, device=logits.device) == flat[..., None]
    dlogits = (torch.exp(lf - lse) - onehot.float()) * g
    return {"Logits@GRAD": [dlogits.to(logits.dtype)]}
