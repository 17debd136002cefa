"""NN lowerings: layer_norm, dropout (inference) and fused_attention (the
port's counterpart of ``paddle_tpu/fluid/ops/nn_ops.py``)."""
import torch

from .registry import register_lowering
from .common import one


@register_lowering("layer_norm")
def _layer_norm(ctx, inputs, attrs):
    """Statistics in f32 (two-pass centered variance, as the JAX lowering),
    affine in f32, result cast back to x's dtype."""
    x = one(inputs, "X")
    scale, bias = one(inputs, "Scale"), one(inputs, "Bias")
    eps = attrs.get("epsilon", 1e-5)
    ax = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(ax, x.ndim))
    lead = tuple(x.shape[:ax])
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    var = (xf - mean).square().mean(dim=axes, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    bshape = (1,) * ax + tuple(x.shape[ax:])
    if scale is not None:
        y = y * scale.reshape(bshape)
    if bias is not None:
        y = y + bias.reshape(bshape)
    return {"Y": [y.to(x.dtype)],
            "Mean": [mean.reshape(lead)],
            "Variance": [var.reshape(lead)]}


@register_lowering("dropout")
def _dropout(ctx, inputs, attrs):
    x = one(inputs, "X")
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if not (attrs.get("is_test", False) or ctx.is_test):
        raise NotImplementedError(
            "training-mode dropout is not ported yet; run the program "
            "cloned with for_test=True")
    out = x if impl == "upscale_in_train" else x * (1.0 - p)
    # all-ones Mask as a broadcast view: no [*, D] buffer is written
    mask = torch.ones((), dtype=torch.uint8, device=x.device).expand(x.shape)
    return {"Out": [out], "Mask": [mask]}


@register_lowering("fused_attention")
def _fused_attention(ctx, inputs, attrs):
    """Fused SDPA on [B, T, H, D]: the one-pass or flash CUDA kernel on the
    card, the dense PyTorch path otherwise (ops/attention.py)."""
    from ...ops.attention import fused_attention_bthd
    q, k, v = one(inputs, "Q"), one(inputs, "K"), one(inputs, "V")
    scale = attrs.get("scale", -1.0)
    scale = None if scale is None or scale < 0 else scale
    if attrs.get("layout", "bhtd") != "bthd":
        raise NotImplementedError(
            "fused_attention layout %r is not ported yet; the Transformer "
            "uses 'bthd'" % attrs.get("layout", "bhtd"))
    return {"Out": [fused_attention_bthd(q, k, v, attrs.get("causal", False),
                                         scale)]}
