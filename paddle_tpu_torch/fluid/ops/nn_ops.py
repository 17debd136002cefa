"""NN lowerings: layer_norm, dropout and its grad, and fused_attention (the
port's counterpart of ``paddle_tpu/fluid/ops/nn_ops.py``).

Dropout keeps the JAX package's semantics: the drop probability quantized
to i/256, a byte-compare keep mask, the upscale by the realized keep
probability, and a backward that does not keep the mask: the forward op
(tagged ``rng_tag`` by the grad maker) snapshots its generator state and
``dropout_grad`` redraws the same bytes. The bytes come from torch's
Philox, not threefry, so masks differ from the JAX package's.
"""
import torch

from .registry import register_lowering, register_grad_maker
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


def _dropout_keep_stats(p):
    """(threshold, realized keep probability) of the byte-compare mask:
    the drop probability is quantized to i/256."""
    thresh = min(max(int(round(p * 256.0)), 0), 256)
    return thresh, (1.0 - thresh / 256.0) if thresh else 1.0


def _dropout_keep(gen, p, shape, device):
    """Keep-mask from one uniform byte per element (torch's Philox draw on
    the card) compared with the threshold, and the realized keep
    probability."""
    thresh, keep_p = _dropout_keep_stats(p)
    if thresh == 0:
        return torch.ones(shape, dtype=torch.bool, device=device), 1.0
    if thresh >= 256:
        return torch.zeros(shape, dtype=torch.bool, device=device), keep_p
    bits8 = torch.empty(shape, dtype=torch.uint8, device=device)
    if gen is not None:
        bits8.random_(0, 256, generator=gen)
    return bits8 >= thresh, keep_p


@register_lowering("dropout")
def _dropout(ctx, inputs, attrs):
    x = one(inputs, "X")
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False) or ctx.is_test:
        out = x if impl == "upscale_in_train" else x * (1.0 - p)
        # all-ones Mask as a broadcast view: no [*, D] buffer is written
        mask = torch.ones((), dtype=torch.uint8,
                          device=x.device).expand(x.shape)
        return {"Out": [out], "Mask": [mask]}
    gen = ctx.next_rng(attrs.get("seed", 0))
    tag = attrs.get("rng_tag")
    if tag is not None and gen is not None:
        # dropout_grad redraws the same mask from this snapshot of the
        # generator instead of keeping the [*, D] mask for the step
        ctx.dropout_states[tag] = gen.get_state()
    keep, keep_p = _dropout_keep(gen, p, x.shape, x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if impl == "upscale_in_train":
        out = torch.where(keep, x / keep_p, zero) if keep_p \
            else torch.zeros_like(x)
    else:
        out = torch.where(keep, x, zero)
    return {"Out": [out], "Mask": [keep.view(torch.uint8)]}


@register_grad_maker("dropout")
def _dropout_grad_maker(op, block, no_grad_set):
    from .. import flags
    out = op.output("Out")[0]
    save_mask = flags.get("dropout_save_mask")
    if not save_mask:
        # tag the forward op: its lowering snapshots the generator under the
        # tag and dropout_grad redraws the identical mask
        op.attrs["rng_tag"] = out
    grad_op = {
        "type": "dropout_grad",
        "inputs": {"Mask": op.output("Mask") if save_mask else ["@EMPTY@"],
                   "Out@GRAD": [out + "@GRAD"]},
        "outputs": {"X@GRAD": [op.input("X")[0] + "@GRAD"]},
        "attrs": dict(op.attrs),
    }
    return [grad_op], {op.input("X")[0] + "@GRAD": op.input("X")[0]}


@register_lowering("dropout_grad")
def _dropout_grad(ctx, inputs, attrs):
    dout = one(inputs, "Out@GRAD")
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False) or ctx.is_test:
        dx = dout if impl == "upscale_in_train" else dout * (1.0 - p)
        return {"X@GRAD": [dx]}
    _, keep_p = _dropout_keep_stats(p)
    if keep_p == 0.0:
        return {"X@GRAD": [torch.zeros_like(dout)]}
    mask = one(inputs, "Mask")
    if mask is None:
        tag = attrs.get("rng_tag")
        state = ctx.dropout_states.get(tag) if tag is not None else None
        if state is None:
            raise RuntimeError(
                "dropout_grad: the forward mask was not kept and no generator "
                "snapshot of its forward op ran in this step; set "
                "FLAGS_dropout_save_mask=1")
        gen = torch.Generator(device=dout.device)
        gen.set_state(state)
        keep, keep_p = _dropout_keep(gen, p, dout.shape, dout.device)
        m = keep.to(dout.dtype)
    else:
        m = mask.to(dout.dtype)
    if impl == "upscale_in_train":
        dx = dout * m / keep_p
    else:
        dx = dout * m
    return {"X@GRAD": [dx]}


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
