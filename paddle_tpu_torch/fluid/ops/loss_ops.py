"""Loss lowerings: softmax_with_cross_entropy forward (the port's
counterpart of ``paddle_tpu/fluid/ops/loss_ops.py``)."""
import torch

from .registry import register_lowering
from .common import one


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
        flat = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 \
            else label
        flat = flat.long()
        v = logits.shape[-1]
        masked = (flat == ignore) | (flat < 0) | (flat >= v)
        picked = torch.gather(lf, -1, flat.clamp(0, v - 1)[..., None])
        loss = torch.where(masked[..., None], torch.zeros_like(lse),
                           lse - picked)
    return {"Softmax": [torch.exp(lf - lse)], "Loss": [loss], "LSE": [lse]}
