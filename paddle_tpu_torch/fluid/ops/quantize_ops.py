"""Fake-quantization lowerings for quantization-aware training: the port's
counterpart of ``paddle_tpu/fluid/ops/quantize_ops.py``, all 8 of its
lowerings with their no-grad flags (reference:
operators/fake_quantize_op.cc, fake_dequantize_op.cc, quantize_op.cc,
dequantize_op.cc).

- ``_quant`` rounds ``clip(x / s, -1, 1) * bnt`` half to even, as
  ``jnp.round`` does, with ``s`` a tensor on x's device: a CUDA kernel
  divides by a Python number through its reciprocal, which moves a value
  on a .5 boundary to its neighbour (``common.true_div``). Each op keeps
  the JAX lowering's epsilon: 1e-8 in ``_quant`` and in the round trips'
  dequantize, none in ``fake_dequantize_max_abs``.
- The straight-through gradient: the five fake-quantize types differentiate
  through ``ste_identity_grad``, which passes ``Out@GRAD`` to ``X@GRAD``
  unchanged, also where the range ops clip (the JAX value).
- The moving-average and range ops read the state ``InScale``; in test mode
  (the op's ``is_test`` or the program's) they use it as the scale.
  ``QuantizeTranspiler.training_transpile`` passes no ``InScale``, so a
  program it builds with those types raises at its first run, in both
  packages (ROADMAP Queue 3).

Plain PyTorch on the op's device, as the JAX lowerings are plain XLA; none
reads a value back to the host.
"""
import torch

from .registry import register_lowering, register_grad_maker
from .common import one


def _bnt(bits):
    return float((1 << (bits - 1)) - 1)


def _quant(x, scale, bits):
    """(round(clip(x / max(scale, 1e-8), -1, 1) * bnt), bnt)."""
    bnt = _bnt(bits)
    s = torch.clamp(scale, min=1e-8)
    return torch.round(torch.clamp(x / s, -1.0, 1.0) * bnt), bnt


def _dequant(q, scale, bnt):
    """q * max(scale, 1e-8) / bnt: the round trips' dequantize."""
    return q * torch.clamp(scale, min=1e-8) / bnt


@register_lowering("fake_quantize_abs_max")
def _fake_quantize_abs_max(ctx, inputs, attrs):
    x = one(inputs, "X")
    scale = x.abs().amax()
    q, _ = _quant(x, scale, attrs.get("bit_length", 8))
    return {"Out": [q], "OutScale": [scale.reshape(1)]}


@register_lowering("fake_dequantize_max_abs")
def _fake_dequantize_max_abs(ctx, inputs, attrs):
    x = one(inputs, "X")
    scale = one(inputs, "Scale")
    bnt = _bnt(attrs.get("bit_length", 8))
    return {"Out": [x * scale.reshape(()) / bnt]}


@register_lowering("fake_quantize_dequantize_abs_max")
def _fake_qdq_abs_max(ctx, inputs, attrs):
    """The QAT round trip in one op: quantize to bit_length, then
    dequantize."""
    x = one(inputs, "X")
    scale = x.abs().amax()
    q, bnt = _quant(x, scale, attrs.get("bit_length", 8))
    return {"Out": [_dequant(q, scale, bnt)],
            "OutScale": [scale.reshape(1)]}


def _test_mode(ctx, attrs):
    return bool(attrs.get("is_test", False) or ctx.is_test)


@register_lowering("fake_quantize_moving_average_abs_max")
def _fake_quantize_moving_avg(ctx, inputs, attrs):
    x = one(inputs, "X")
    in_scale = one(inputs, "InScale")
    rate = attrs.get("moving_rate", 0.9)
    cur = x.abs().amax()
    if _test_mode(ctx, attrs):
        scale = in_scale.reshape(())
    else:
        scale = rate * in_scale.reshape(()) + (1.0 - rate) * cur
    q, bnt = _quant(x, scale, attrs.get("bit_length", 8))
    return {"Out": [_dequant(q, scale, bnt)],
            "OutScale": [scale.reshape(1)]}


@register_lowering("fake_quantize_range_abs_max")
def _fake_quantize_range_abs_max(ctx, inputs, attrs):
    x = one(inputs, "X")
    in_scale = one(inputs, "InScale")
    cur = x.abs().amax()
    if _test_mode(ctx, attrs):
        scale = in_scale.reshape(())
    else:
        scale = torch.maximum(in_scale.reshape(()), cur)
    q, bnt = _quant(x, scale, attrs.get("bit_length", 8))
    return {"Out": [_dequant(q, scale, bnt)],
            "OutScale": [scale.reshape(1)]}


# the types whose gradient is the straight-through estimator
STE_TYPES = ("fake_quantize_abs_max", "fake_quantize_dequantize_abs_max",
             "fake_quantize_moving_average_abs_max",
             "fake_quantize_range_abs_max", "fake_dequantize_max_abs")


def _ste_grad_maker(op, block, no_grad_set):
    """Straight-through: dX = dOut (the clipped region passes through)."""
    out = op.output("Out")[0]
    x = op.input("X")[0]
    grad_op = {
        "type": "ste_identity_grad",
        "inputs": {"Out@GRAD": [out + "@GRAD"]},
        "outputs": {"X@GRAD": [x + "@GRAD"]},
        "attrs": {},
    }
    return [grad_op], {x + "@GRAD": x}


for _t in STE_TYPES:
    register_grad_maker(_t)(_ste_grad_maker)


@register_lowering("ste_identity_grad", no_grad=True)
def _ste_identity_grad(ctx, inputs, attrs):
    return {"X@GRAD": [one(inputs, "Out@GRAD")]}


# int8 inference-side ops (reference: quantize_op.cc / dequantize_op.cc)
@register_lowering("quantize", no_grad=True)
def _quantize(ctx, inputs, attrs):
    x = one(inputs, "Input")
    scale = attrs.get("Scale", 1.0)
    return {"Output": [torch.clamp(torch.round(x * scale), -128, 127)
                       .to(torch.int8)]}


@register_lowering("dequantize", no_grad=True)
def _dequantize(ctx, inputs, attrs):
    x = one(inputs, "Input")
    scale = attrs.get("Scale", 1.0)
    return {"Output": [x.to(torch.float32) / scale]}
