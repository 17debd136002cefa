"""Optimizer-update lowerings: sgd and dense adam (the port's counterpart of
``paddle_tpu/fluid/ops/optimizer_ops.py``). Both are no-grad.

adam keeps the JAX package's dispatch: the fused CUDA kernel
(ops/adam_kernel.py) when FLAGS_adam_kernel is on, the tensors are on the
card and ``adam_ok(shape)`` admits the parameter; the plain update
otherwise. The kernel updates Param, Moment1 and Moment2 in place; the
plain path returns new tensors. lr_t = lr*sqrt(1-b2^t)/(1-b1^t) and the
beta-power updates stay outside the kernel, on the device: the kernel reads
lr_t through a pointer, so a step costs no host sync. The sparse (GradRows)
and lazy paths come with the DeepFM slice.
"""
import torch

from .registry import register_lowering
from .common import one


def _adam_kernel_ok(p):
    from .. import flags
    if not flags.get("adam_kernel"):
        return False
    from ...ops.adam_kernel import adam_ok
    return p.is_cuda and adam_ok(p.shape)


def _no_rows(inputs, op_type):
    if inputs.get("GradRows"):
        raise NotImplementedError(
            "%s with sparse GradRows is not ported yet" % op_type)


@register_lowering("sgd", no_grad=True)
def _sgd(ctx, inputs, attrs):
    _no_rows(inputs, "sgd")
    p, g = one(inputs, "Param"), one(inputs, "Grad")
    lr = one(inputs, "LearningRate").reshape(()).to(p.dtype)
    return {"ParamOut": [p - lr * g.to(p.dtype)]}


@register_lowering("adam", no_grad=True)
def _adam(ctx, inputs, attrs):
    _no_rows(inputs, "adam")
    p, g = one(inputs, "Param"), one(inputs, "Grad")
    m1, m2 = one(inputs, "Moment1"), one(inputs, "Moment2")
    b1p, b2p = one(inputs, "Beta1Pow"), one(inputs, "Beta2Pow")
    lr = one(inputs, "LearningRate").reshape(()).float()
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr_t = lr * torch.sqrt(1.0 - b2p.reshape(())) / (1.0 - b1p.reshape(()))
    if _adam_kernel_ok(p):
        from ...ops.adam_kernel import adam_update
        p_out, m1_out, m2_out = adam_update(p, g.contiguous(), m1, m2, lr_t,
                                            b1, b2, eps)
    else:
        gf = g.float()
        m1_out = b1 * m1 + (1.0 - b1) * gf
        m2_out = b2 * m2 + (1.0 - b2) * torch.square(gf)
        p_out = p - (lr_t * m1_out / (torch.sqrt(m2_out) + eps)).to(p.dtype)
    return {"ParamOut": [p_out], "Moment1Out": [m1_out],
            "Moment2Out": [m2_out],
            "Beta1PowOut": [b1p * b1], "Beta2PowOut": [b2p * b2]}
