"""NN lowerings: the convolutions (conv2d, depthwise_conv2d,
conv2d_transpose, conv3d), pool2d and pool3d, batch_norm and its grad,
layer_norm, group_norm, data_norm, affine_channel, lrn, dropout and its
grad, fused_attention, the resizes and grid_sampler, im2sequence,
bilinear_tensor_product, row_conv and conv_shift (the port's counterpart
of ``paddle_tpu/fluid/ops/nn_ops.py``).

Every convolution is ``aten.convolution`` (cuDNN on the card), as the JAX
package's is XLA's; a float32 convolution, transposed or 3-D too, runs in
true f32 on the card, forward and backward (``_ConvF32``). pool2d pads
explicitly, as the JAX package's ``reduce_window`` does, so every
attribute (ceil_mode's extra right and bottom padding, exclusive counts,
global and adaptive windows) keeps its windows; pool3d reads only the
window, stride and padding, as the JAX lowering. batch_norm follows the
JAX lowering's formula in plain torch ops, not ``F.batch_norm``: f32 batch
statistics as E[x^2] - E[x]^2 (the biased variance), running statistics
blended with ``momentum``, and SavedVariance = rsqrt(var + eps). Its grad
op ``batch_norm_grad`` is the gradient of that formula; the executor pairs
it with its forward op and hands it that op's SavedMean and
SavedVariance, so no statistic is computed twice.

Dropout keeps the JAX package's semantics: the drop probability quantized
to i/256, a byte-compare keep mask, the upscale by the realized keep
probability, and a backward that does not keep the mask: the forward op
(tagged ``rng_tag`` by the grad maker) snapshots its generator state and
``dropout_grad`` redraws the same bytes. The bytes come from torch's
Philox, not threefry, so masks differ from the JAX package's.
"""
import contextlib
import math

import torch
import torch.nn.functional as F

from . import common
from .registry import (register_lowering, register_grad_maker,
                       register_paired_grad)
from .common import one


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v] * n


# cuDNN's precision for float32 convolutions inside the conv2d lowering.
# cuDNN's own default lets an f32 convolution round its operands to TF32,
# where the port's f32 matmuls and the JAX package compute in f32; the
# lowering sets this per-operator precision for its call and its backward
# and restores the caller's after, leaving the process-wide settings alone.
CONV_FP32_PRECISION = "ieee"


@contextlib.contextmanager
def _cudnn_fp32_precision():
    """cuDNN convolutions (and, to keep the two consistent for readers of
    the legacy ``allow_tf32`` flag, RNNs) at CONV_FP32_PRECISION for the
    block."""
    cudnn = torch.backends.cudnn
    saved = cudnn.conv.fp32_precision, cudnn.rnn.fp32_precision
    cudnn.conv.fp32_precision = cudnn.rnn.fp32_precision = \
        CONV_FP32_PRECISION
    try:
        yield
    finally:
        cudnn.conv.fp32_precision, cudnn.rnn.fp32_precision = saved


class _ConvF32(torch.autograd.Function):
    """A float32 ``aten.convolution`` (2-D or 3-D, plain or transposed)
    whose forward and backward both run under ``_cudnn_fp32_precision``:
    autograd runs a backward after the forward's scope has closed, so the
    backward enters it again."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, transposed, groups):
        ctx.save_for_backward(x, w)
        ctx.conv = (stride, padding, dilation, transposed,
                    [0] * len(stride), groups)
        with _cudnn_fp32_precision():
            return torch.ops.aten.convolution(x, w, None, *ctx.conv)

    @staticmethod
    def backward(ctx, dout):
        x, w = ctx.saved_tensors
        with _cudnn_fp32_precision():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                dout, x, w, None, *ctx.conv,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw, None, None, None, None, None


def convolution(x, w, stride, padding, dilation, groups, transposed=False):
    """N-D convolution of NC... input by an O/I... filter (transposed: the
    filter in Fluid's [in_c, out_c / groups, k...] layout, which is
    ``F.conv_transpose*d``'s): float32 through ``_ConvF32``, other dtypes
    through the plain call. The output keeps x's dtype."""
    n = x.ndim - 2
    conv = ([int(v) for v in _pair(stride, n)],
            [int(v) for v in _pair(padding, n)],
            [int(v) for v in _pair(dilation, n)])
    if x.dtype == torch.float32:
        return _ConvF32.apply(x, w, *conv, transposed, groups)
    return torch.ops.aten.convolution(x, w, None, *conv, transposed,
                                      [0] * n, groups).to(x.dtype)


@register_lowering("conv2d")
def _conv2d(ctx, inputs, attrs):
    """NCHW input, OIHW filter, symmetric padding; output in the input's
    dtype. Its gradient is the generic ``grad_of`` on the taped forward."""
    x, w = one(inputs, "Input"), one(inputs, "Filter")
    out = convolution(x, w, attrs.get("strides", [1, 1]),
                      attrs.get("paddings", [0, 0]),
                      attrs.get("dilations", [1, 1]),
                      attrs.get("groups", 1) or 1)
    return {"Output": [out]}


@register_lowering("depthwise_conv2d")
def _depthwise_conv2d(ctx, inputs, attrs):
    """conv2d with groups set to the input's channels (a channel multiplier
    of num_filters / channels): the same routes, float32 through
    ``_ConvF32``."""
    return _conv2d(ctx, inputs,
                   dict(attrs, groups=one(inputs, "Input").shape[1]))


@register_lowering("conv2d_transpose")
def _conv2d_transpose(ctx, inputs, attrs):
    """The transposed convolution of ``conv_transpose_nd`` (the JAX
    package's input-dilated convolution by the flipped filter): output
    size (in - 1) * stride - 2 * pad + dilation * (k - 1) + 1."""
    x, w = one(inputs, "Input"), one(inputs, "Filter")
    out = convolution(x, w, attrs.get("strides", [1, 1]),
                      attrs.get("paddings", [0, 0]),
                      attrs.get("dilations", [1, 1]),
                      attrs.get("groups", 1) or 1, transposed=True)
    return {"Output": [out]}


@register_lowering("conv3d")
def _conv3d(ctx, inputs, attrs):
    """NCDHW input, OIDHW filter, symmetric padding; the input's dtype."""
    x, w = one(inputs, "Input"), one(inputs, "Filter")
    out = convolution(x, w, attrs.get("strides", [1, 1, 1]),
                      attrs.get("paddings", [0, 0, 0]),
                      attrs.get("dilations", [1, 1, 1]),
                      attrs.get("groups", 1) or 1)
    return {"Output": [out]}


def _pool_out_size(in_size, k, s, p, ceil_mode):
    if ceil_mode:
        return (in_size - k + 2 * p + s - 1) // s + 1
    return (in_size - k + 2 * p) // s + 1


@register_lowering("pool2d")
def _pool2d(ctx, inputs, attrs):
    """Max or average pooling over NCHW windows of the JAX lowering's
    padding: max pads with -inf (the integer minimum for integer input),
    average sums zero-padded windows and divides by the count of real
    elements (exclusive) or by the window size. Max pooling's gradient
    goes to the first maximum of each window in row-major order, where the
    JAX package's ``reduce_window`` vjp (select_and_scatter_add with
    ``ge``) sends it."""
    x = one(inputs, "X")
    ptype = attrs.get("pooling_type", "max")
    ksize = _pair(attrs.get("ksize", [2, 2]))
    strides = _pair(attrs.get("strides", [1, 1]))
    pads = _pair(attrs.get("paddings", [0, 0]))
    if attrs.get("global_pooling", False):
        ksize, pads, strides = [x.shape[2], x.shape[3]], [0, 0], [1, 1]
    if attrs.get("adaptive", False):
        # adaptive pooling to the target size ksize: exact division only
        kh, kw = x.shape[2] // ksize[0], x.shape[3] // ksize[1]
        ksize, strides, pads = [kh, kw], [kh, kw], [0, 0]
    pad_h, pad_w = [pads[0], pads[0]], [pads[1], pads[1]]
    if attrs.get("ceil_mode", False):
        oh = _pool_out_size(x.shape[2], ksize[0], strides[0], pads[0], True)
        ow = _pool_out_size(x.shape[3], ksize[1], strides[1], pads[1], True)
        pad_h[1] += max((oh - 1) * strides[0] + ksize[0] -
                        (x.shape[2] + 2 * pads[0]), 0)
        pad_w[1] += max((ow - 1) * strides[1] + ksize[1] -
                        (x.shape[3] + 2 * pads[1]), 0)
    padding = (pad_w[0], pad_w[1], pad_h[0], pad_h[1])
    padded = any(padding)
    if ptype == "max":
        floating = x.dtype.is_floating_point
        fill = -math.inf if floating else torch.iinfo(x.dtype).min
        xp = F.pad(x, padding, value=fill) if padded else x
        if floating:
            out = F.max_pool2d(xp, ksize, strides)
        else:
            out = xp.unfold(2, ksize[0], strides[0]).unfold(
                3, ksize[1], strides[1]).amax(dim=(-2, -1))
        return {"Out": [out]}
    xp = F.pad(x, padding) if padded else x
    # the window sums in x's dtype, then divided, as the JAX lowering
    summed = F.avg_pool2d(xp, ksize, strides, divisor_override=1)
    if attrs.get("exclusive", True):
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        ones = F.pad(ones, padding) if padded else ones
        out = summed / F.avg_pool2d(ones, ksize, strides, divisor_override=1)
    else:
        out = summed / (ksize[0] * ksize[1])
    return {"Out": [out.to(x.dtype)]}


def _bn_layout(x, layout):
    """(the reduced axes, the broadcast shape of a per-channel vector)."""
    ch = x.ndim - 1 if layout == "NHWC" else 1
    shape = [1] * x.ndim
    shape[ch] = -1
    return tuple(i for i in range(x.ndim) if i != ch), shape


def _bn_core(x, scale, bias, mean, inv, shape):
    """(x - mean) * (inv * scale) + bias, per channel, as the JAX
    lowering's ``_bn_core`` with inv = rsqrt(var + eps)."""
    return (x - mean.reshape(shape)) * (inv * scale).reshape(shape) + \
        bias.reshape(shape)


def _bn_batch_stats(xf, axes):
    """The f32 batch mean and biased variance, E[x^2] - E[x]^2."""
    bmean = xf.mean(dim=axes)
    return bmean, xf.square().mean(dim=axes) - bmean.square()


def _bn_uses_global_stats(attrs):
    return attrs.get("is_test", False) or \
        attrs.get("use_global_stats", False)


@register_lowering("batch_norm")
def _batch_norm(ctx, inputs, attrs):
    """Training: Y from the batch statistics in f32, cast back to X's dtype;
    MeanOut = Mean * momentum + batch mean * (1 - momentum), VarianceOut
    the same with the biased batch variance; SavedMean is the batch mean,
    SavedVariance rsqrt(batch variance + eps). is_test or use_global_stats:
    Y from the running statistics (in the promoted dtype, as the JAX
    lowering leaves it), which pass through."""
    x = one(inputs, "X")
    scale, bias = one(inputs, "Scale"), one(inputs, "Bias")
    mean, var = one(inputs, "Mean"), one(inputs, "Variance")
    eps = float(attrs.get("epsilon", 1e-5))
    momentum = attrs.get("momentum", 0.9)
    axes, shape = _bn_layout(x, attrs.get("data_layout", "NCHW"))
    if _bn_uses_global_stats(attrs):
        inv = torch.rsqrt(var + eps)
        y = _bn_core(x, scale, bias, mean, inv, shape)
        return {"Y": [y], "MeanOut": [mean], "VarianceOut": [var],
                "SavedMean": [mean], "SavedVariance": [inv]}
    xf = x.float()
    bmean, bvar = _bn_batch_stats(xf, axes)
    inv = torch.rsqrt(bvar + eps)
    y = _bn_core(xf, scale, bias, bmean, inv, shape).to(x.dtype)
    return {"Y": [y],
            "MeanOut": [mean * momentum + bmean * (1.0 - momentum)],
            "VarianceOut": [var * momentum + bvar * (1.0 - momentum)],
            "SavedMean": [bmean], "SavedVariance": [inv]}


@register_grad_maker("batch_norm")
def _batch_norm_grad_maker(op, block, no_grad_set):
    """The JAX package's maker: one batch_norm_grad op, gradients to X,
    Scale and Bias only (the running statistics carry none)."""
    y = op.output("Y")[0]
    grad_op = {
        "type": "batch_norm_grad",
        "inputs": {"X": op.input("X"), "Scale": op.input("Scale"),
                   "Bias": op.input("Bias"), "Mean": op.input("Mean"),
                   "Variance": op.input("Variance"), "Y@GRAD": [y + "@GRAD"]},
        "outputs": {"X@GRAD": [op.input("X")[0] + "@GRAD"],
                    "Scale@GRAD": [op.input("Scale")[0] + "@GRAD"],
                    "Bias@GRAD": [op.input("Bias")[0] + "@GRAD"]},
        "attrs": dict(op.attrs),
    }
    g2v = {op.input("X")[0] + "@GRAD": op.input("X")[0],
           op.input("Scale")[0] + "@GRAD": op.input("Scale")[0],
           op.input("Bias")[0] + "@GRAD": op.input("Bias")[0]}
    return [grad_op], g2v


# batch_norm_grad reads the batch statistics of the batch_norm op it
# differentiates (the one with the same five inputs)
register_paired_grad("batch_norm_grad", "batch_norm",
                     ("X", "Scale", "Bias", "Mean", "Variance"))


@register_lowering("batch_norm_grad", no_grad=True)
def _batch_norm_grad(ctx, inputs, attrs):
    """The vjp of batch_norm's Y in X, Scale and Bias, term by term as
    ``jax.vjp`` of the JAX lowering's formula computes it, in f32: through
    (x - mean) * a + bias with a = inv * scale, inv = rsqrt(var + eps),
    and, in training, mean = E[x] and var = E[x^2] - mean^2. The batch
    mean and inv come from the paired forward op's SavedMean and
    SavedVariance (``ctx.record``), or from X when the op runs alone.
    X@GRAD comes back in X's dtype."""
    x = one(inputs, "X")
    scale = one(inputs, "Scale")
    dy = one(inputs, "Y@GRAD")
    eps = float(attrs.get("epsilon", 1e-5))
    axes, shape = _bn_layout(x, attrs.get("data_layout", "NCHW"))
    g = dy.float()
    if _bn_uses_global_stats(attrs):
        mean = one(inputs, "Mean")
        inv = torch.rsqrt(one(inputs, "Variance") + eps)
        a = inv * scale
        dbias = g.sum(dim=axes)
        s = (g * (x - mean.reshape(shape))).sum(dim=axes)
        return {"X@GRAD": [(g * a.reshape(shape)).to(x.dtype)],
                "Scale@GRAD": [s * inv], "Bias@GRAD": [dbias]}
    xf = x.float()
    if ctx.record is not None:
        bmean = ctx.record.outs["SavedMean"][0]
        inv = ctx.record.outs["SavedVariance"][0]
    else:
        bmean, bvar = _bn_batch_stats(xf, axes)
        inv = torch.rsqrt(bvar + eps)
    n = xf.numel() // bmean.numel()
    a = inv * scale
    dbias = g.sum(dim=axes)
    s = (g * (xf - bmean.reshape(shape))).sum(dim=axes)
    # d inv = s * scale; d var = d inv * -inv^3 / 2; var = E[x^2] - mean^2
    dvar = s * scale * (-0.5 * inv * inv * inv)
    dmean = -dbias * a - 2.0 * bmean * dvar
    dx = g * a.reshape(shape) + (dmean / n).reshape(shape) + \
        xf * (2.0 * dvar / n).reshape(shape)
    return {"X@GRAD": [dx.to(x.dtype)], "Scale@GRAD": [s * inv],
            "Bias@GRAD": [dbias]}


def _ln_stats(xf, axes):
    """Two-pass centered mean and variance in f32, as the JAX lowering."""
    mean = xf.mean(dim=axes, keepdim=True)
    var = (xf - mean).square().mean(dim=axes, keepdim=True)
    return mean, var


class _LnAffine(torch.autograd.Function):
    """Affine LayerNorm over the last axis of 2-D x whose backward is the
    LayerNorm-backward CUDA kernel (ops/layernorm_kernel.py): the
    counterpart of the JAX package's ``custom_vjp`` ``_ln_affine``
    (paddle_tpu/fluid/ops/nn_ops.py:259). The forward is plain f32 and
    saves only (x, scale); the statistics come out as non-differentiable
    outputs, so the op's Mean and Variance are computed once."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        xf = x.float()
        mean, var = _ln_stats(xf, (1,))
        y = ((xf - mean) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        from ...ops.layernorm_kernel import ln_backward
        x, scale = ctx.saved_tensors
        dx, dg, db = ln_backward(x, dy.contiguous(), scale, ctx.eps)
        return dx, dg.to(scale.dtype), db.to(scale.dtype), None


def _ln_kernel_ok(x, scale, bias, ax):
    """The JAX package's gate: the flag, scale and bias present, the
    tensors on the card, and ``ln_bwd_ok`` on the flat [rows, d] shape."""
    from .. import flags
    from ...ops.layernorm_kernel import ln_bwd_ok
    if not flags.get("ln_kernel"):
        return False
    if scale is None or bias is None:
        return False
    d = math.prod(x.shape[ax:])
    rows = x.numel() // max(1, d)
    return common.on_card(x) and ln_bwd_ok(rows, d)


@register_lowering("layer_norm")
def _layer_norm(ctx, inputs, attrs):
    """Statistics in f32 (two-pass centered variance, as the JAX lowering),
    affine in f32, result cast back to x's dtype. With FLAGS_ln_kernel the
    affine form runs through ``_LnAffine``, whose backward is the CUDA
    kernel: the op's gradient is the generic ``grad_of`` on the taped
    forward, so it runs inside that op's ``torch.autograd.grad``."""
    x = one(inputs, "X")
    scale, bias = one(inputs, "Scale"), one(inputs, "Bias")
    eps = attrs.get("epsilon", 1e-5)
    ax = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(ax, x.ndim))
    lead = tuple(x.shape[:ax])
    if _ln_kernel_ok(x, scale, bias, ax):
        d = math.prod(x.shape[ax:])
        y, mean, var = _LnAffine.apply(
            x.reshape(-1, d).contiguous(), scale.float().reshape(d),
            bias.float().reshape(d), float(eps))
        return {"Y": [y.reshape(x.shape)], "Mean": [mean.reshape(lead)],
                "Variance": [var.reshape(lead)]}
    xf = x.float()
    mean, var = _ln_stats(xf, axes)
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
    """Fused SDPA in the op's layout: on [B, T, H, D] ("bthd") the one-pass
    or flash CUDA kernel on the card, the dense PyTorch path otherwise; on
    [B, H, T, D] ("bhtd", the default) the flash kernels from
    FLAGS_flash_min_seq keys on the card, the dense reference otherwise
    (ops/attention.py)."""
    from ...ops.attention import fused_attention, fused_attention_bthd
    q, k, v = one(inputs, "Q"), one(inputs, "K"), one(inputs, "V")
    scale = attrs.get("scale", -1.0)
    scale = None if scale is None or scale < 0 else scale
    fn = fused_attention_bthd if attrs.get("layout", "bhtd") == "bthd" \
        else fused_attention
    return {"Out": [fn(q, k, v, attrs.get("causal", False), scale)]}


@register_lowering("pool3d")
def _pool3d(ctx, inputs, attrs):
    """Max or average pooling over NCDHW windows, as the JAX lowering: the
    windows padded by hand (max with -inf, so any padding is taken, where
    ``F.max_pool3d`` refuses one over half the window), average always
    divided by the window's size, and ``exclusive``, ``ceil_mode`` and
    ``adaptive`` not read (so ``adaptive_pool3d`` pools by a window of
    ``pool_size`` at stride 1). Average sums in float32, rounded once."""
    x = one(inputs, "X")
    ksize = _pair(attrs.get("ksize", [2, 2, 2]), 3)
    strides = _pair(attrs.get("strides", [1, 1, 1]), 3)
    pads = _pair(attrs.get("paddings", [0, 0, 0]), 3)
    if attrs.get("global_pooling", False):
        ksize, pads, strides = list(x.shape[2:]), [0, 0, 0], [1, 1, 1]
    padding = (pads[2], pads[2], pads[1], pads[1], pads[0], pads[0])
    if attrs.get("pooling_type", "max") == "max":
        xp = F.pad(x, padding, value=-math.inf) if any(pads) else x
        return {"Out": [F.max_pool3d(xp, ksize, strides)]}
    xf = x.float()
    xp = F.pad(xf, padding) if any(pads) else xf
    summed = F.avg_pool3d(xp, ksize, strides, divisor_override=1)
    return {"Out": [(summed / math.prod(ksize)).to(x.dtype)]}


@register_lowering("group_norm")
def _group_norm(ctx, inputs, attrs):
    """Statistics over each group of C / groups channels and the spatial
    axes, the variance two-pass and centered, computed in float32 and
    rounded once; Y, Mean and Variance ([N, groups]) in X's dtype (the JAX
    lowering promotes Y to float32 past a bf16 X's float32 Scale: ROADMAP
    Queue 3)."""
    x = one(inputs, "X")
    scale, bias = one(inputs, "Scale"), one(inputs, "Bias")
    eps = attrs.get("epsilon", 1e-5)
    groups = attrs.get("groups", 1)
    n, c = x.shape[0], x.shape[1]
    xg = x.float().reshape((n, groups, c // groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, xg.ndim))
    mean = xg.mean(dim=axes, keepdim=True)
    var = (xg - mean).square().mean(dim=axes, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    cshape = (1, c) + (1,) * (x.ndim - 2)
    if scale is not None:
        y = y * scale.reshape(cshape)
    if bias is not None:
        y = y + bias.reshape(cshape)
    return {"Y": [y.to(x.dtype)],
            "Mean": [mean.reshape(n, groups).to(x.dtype)],
            "Variance": [var.reshape(n, groups).to(x.dtype)]}


@register_lowering("data_norm")
def _data_norm(ctx, inputs, attrs):
    """(X - BatchSum / BatchSize) * sqrt(BatchSize / BatchSquareSum); the
    three statistics are parameters, and the gradient reaches them."""
    x = one(inputs, "X")
    bsize = one(inputs, "BatchSize")
    means = one(inputs, "BatchSum") / bsize
    scales = torch.sqrt(bsize / one(inputs, "BatchSquareSum"))
    return {"Y": [(x - means) * scales], "Means": [means],
            "Scales": [scales]}


@register_lowering("affine_channel")
def _affine_channel(ctx, inputs, attrs):
    x = one(inputs, "X")
    scale, bias = one(inputs, "Scale"), one(inputs, "Bias")
    shape = ((1, -1) + (1,) * (x.ndim - 2)) \
        if attrs.get("data_layout", "NCHW") == "NCHW" \
        else ((1,) * (x.ndim - 1) + (-1,))
    return {"Out": [x * scale.reshape(shape) + bias.reshape(shape)]}


@register_lowering("lrn")
def _lrn(ctx, inputs, attrs):
    """Across-channel LRN as the JAX lowering: MidOut = k + alpha * (the
    sum of x^2 over n channels centred on each, zero-padded; alpha not
    divided by n, as ``F.local_response_norm`` divides it), Out = x /
    MidOut^beta. The n shifted squares add in order."""
    x = one(inputs, "X")
    n = attrs.get("n", 5)
    k = attrs.get("k", 2.0)
    alpha, beta = attrs.get("alpha", 1e-4), attrs.get("beta", 0.75)
    half = n // 2
    sq = F.pad(x.square(), (0, 0, 0, 0, half, half))
    c = x.shape[1]
    acc = sum(sq[:, i:i + c] for i in range(n))
    mid = k + alpha * acc
    return {"Out": [x / mid.pow(beta)], "MidOut": [mid]}


def _resize(x, oh, ow, mode, **kw):
    """F.interpolate to [oh, ow]; half precision resized in float32 (the
    CPU has no bfloat16 antialiasing kernel) and rounded once."""
    out = F.interpolate(x.to(common.compute_dtype(x)), (int(oh), int(ow)),
                        mode=mode, **kw)
    return out.to(x.dtype)


@register_lowering("bilinear_interp")
def _bilinear_interp(ctx, inputs, attrs):
    """``jax.image.resize(..., "bilinear")``: half-pixel centres, and an
    antialiasing triangle filter when it shrinks, which is
    ``F.interpolate(align_corners=False, antialias=True)``; the layer's
    align_corners is not passed (ROADMAP Queue 3)."""
    if one(inputs, "OutSize") is not None:
        raise NotImplementedError("dynamic OutSize is not supported; set "
                                  "out_h/out_w statically")
    x = one(inputs, "X")
    return {"Out": [_resize(x, attrs.get("out_h"), attrs.get("out_w"),
                            "bilinear", align_corners=False,
                            antialias=True)]}


@register_lowering("nearest_interp")
def _nearest_interp(ctx, inputs, attrs):
    """``jax.image.resize(..., "nearest")``: the source pixel whose
    half-pixel centre is nearest, ``mode="nearest-exact"``."""
    x = one(inputs, "X")
    return {"Out": [_resize(x, attrs.get("out_h"), attrs.get("out_w"),
                            "nearest-exact")]}


def grid_sample_border(x, grid):
    """Bilinear sampling of NCHW x at grid [N, H', W', 2] (x, y in [-1, 1]
    over the corners), the JAX lowering's formula op by op: coordinates
    (g + 1) * (size - 1) / 2, the four corners' indices clamped into the
    image, weights from the unclamped coordinates. Elementwise ops, each
    rounded once on the card and on the CPU alike, so both take the same
    side of a pixel centre, where the derivative in the coordinate jumps;
    the picks' gradient adds rows in order (``_Gather``)."""
    from .tensor_ops import _Gather
    n, c, h, w = x.shape
    gx = (grid[..., 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[..., 1] + 1.0) * (h - 1) / 2.0
    x0, y0 = torch.floor(gx), torch.floor(gy)
    x1, y1 = x0 + 1, y0 + 1
    rows = x.permute(0, 2, 3, 1).reshape(n * h * w, c)
    base = (torch.arange(n, device=x.device) * (h * w))[:, None, None]

    def sample(yy, xx):
        yy = torch.clamp(yy, 0, h - 1).long()
        xx = torch.clamp(xx, 0, w - 1).long()
        idx = (base + yy * w + xx).reshape(-1)
        return _Gather.apply(rows, idx).reshape(tuple(grid.shape[:3]) + (c,))

    wa = ((x1 - gx) * (y1 - gy))[..., None]
    wb = ((x1 - gx) * (gy - y0))[..., None]
    wc = ((gx - x0) * (y1 - gy))[..., None]
    wd = ((gx - x0) * (gy - y0))[..., None]
    out = wa * sample(y0, x0) + wb * sample(y1, x0) + \
        wc * sample(y0, x1) + wd * sample(y1, x1)
    return out.permute(0, 3, 1, 2)


@register_lowering("grid_sampler")
def _grid_sampler(ctx, inputs, attrs):
    """``grid_sample_border``: bilinear, align-corners coordinates, the
    border's value past the image (the Paddle reference pads with zeros:
    ROADMAP Queue 3), as ``F.grid_sample(padding_mode="border",
    align_corners=True)`` gives within rounding. Half precision samples in
    float32 (a bfloat16 coordinate is off by up to a pixel over 128) and
    is rounded once."""
    x, grid = one(inputs, "X"), one(inputs, "Grid")
    dtype = common.compute_dtype(x)
    out = grid_sample_border(x.to(dtype), grid.to(dtype))
    return {"Output": [out.to(x.dtype)]}


@register_lowering("im2sequence")
def _im2sequence(ctx, inputs, attrs):
    """Each kernels-sized patch of the padded NCHW input (paddings: top,
    left, bottom, right) as a row [C * kh * kw], C major (``F.unfold``'s
    order); rows [N * oh * ow], no LoD."""
    x = one(inputs, "X")
    kh, kw = attrs["kernels"]
    strides = attrs.get("strides", [1, 1])
    p = attrs.get("paddings", [0, 0, 0, 0])
    xp = F.pad(x, (p[1], p[3], p[0], p[2])) if any(p) else x
    cols = F.unfold(xp, (kh, kw), stride=tuple(strides))
    return {"Out": [cols.transpose(1, 2).reshape(-1, cols.shape[1])]}


@register_lowering("bilinear_tensor_product")
def _bilinear_tensor_product(ctx, inputs, attrs):
    """out[b, o] = x[b] W[o] y[b] (+ bias), W [out, dx, dy]."""
    x, y, w = one(inputs, "X"), one(inputs, "Y"), one(inputs, "Weight")
    bias = one(inputs, "Bias")
    out = torch.einsum("bi,oij,bj->bo", x, w, y)
    if bias is not None:
        out = out + bias
    return {"Out": [out]}


@register_lowering("row_conv")
def _row_conv(ctx, inputs, attrs):
    """Lookahead convolution over [B, T, D]: out[t] = sum_i x[t + i] *
    Filter[i], i < future_context + 1, past the end zeros; the terms add
    in order of i."""
    x, w = one(inputs, "X"), one(inputs, "Filter")
    k, t = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, 0, k - 1))
    return {"Out": [sum(pad[:, i:i + t] * w[i] for i in range(k))]}


@register_lowering("conv_shift")
def _conv_shift(ctx, inputs, attrs):
    """Circular convolution of each row of X [B, M] with its row of Y [B,
    N]: out[:, i] = sum_j x[:, (i + j - (N - 1) // 2) % M] * y[:, j], the
    shifted copies as rolls."""
    x, y = one(inputs, "X"), one(inputs, "Y")
    n = y.shape[1]
    half = (n - 1) // 2
    terms = torch.stack([torch.roll(x, half - j, 1) * y[:, j:j + 1]
                         for j in range(n)], dim=-1)
    return {"Out": [terms.sum(dim=-1)]}
