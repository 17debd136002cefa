"""Optimizer-update lowerings: sgd, momentum and adam, sgd and adam dense
and sparse (the port's counterpart of
``paddle_tpu/fluid/ops/optimizer_ops.py``). All are no-grad.

momentum updates in the velocity's dtype (f32 for a bf16 parameter) and
rounds the step to the parameter's dtype once. A training program's
momentum ops (one per parameter; ResNet-50 has 161) come one after
another, and the executor hands such a run to ``_momentum_group``, which
updates it with ``torch._foreach_*`` calls, bit for bit the per-op
formula.

adam keeps the JAX package's dispatch: the fused CUDA kernel
(ops/adam_kernel.py) when FLAGS_adam_kernel is on, the tensors are on the
card and ``adam_ok(shape)`` admits the parameter; the plain update
otherwise. The kernel updates Param, Moment1 and Moment2 in place; the
plain path returns new tensors. lr_t = lr*sqrt(1-b2^t)/(1-b1^t) and the
beta-power updates stay outside the kernel, on the device: the kernel reads
lr_t through a pointer, so a step costs no host sync.

A training program's adam ops (one per parameter) come one after another.
The executor hands such a run to ``_adam_group`` at once (registry
``register_group_lowering``): every admitted parameter of the run goes to
one multi-tensor kernel launch, and lr_t and the beta powers of the whole
run come from ``torch._foreach_*`` ops over its lists, with the rounding of
the per-op formula. The program stays op for op the JAX package's; only the
launches change. A lone adam op is a run of one.

Sparse path (the JAX package's SelectedRows kernels): an op with a
"GradRows" input takes Grad as [n, dim] row values and GradRows as their
ids (the ``@ROWS`` pair of a sparse ``lookup_table_grad``). sgd scatters
-lr * values into the touched rows; adam with ``lazy_mode`` merges
duplicate ids and updates only the touched rows' moments and parameters,
and without it (the default) scatters the pair into a dense f32 gradient
and runs the dense update, since every row's moments decay each step. Such
an op runs alone, never through the kernel, as in the JAX package.
"""
import torch

from .registry import register_group_lowering, register_lowering
from .common import one
from .tensor_ops import scatter_rows_, wrap_ids


def _adam_kernel_ok(p):
    from .. import flags
    if not flags.get("adam_kernel"):
        return False
    from ...ops.adam_kernel import adam_ok
    return p.is_cuda and adam_ok(p.shape)


def _merge_rows(rows, vals, height):
    """Duplicate ids merged: (the distinct ids in [0, height), ascending,
    and for each the f32 sum of its values, added in their order in the
    batch), as the JAX package's ``_merge_rows`` sorts and segment-sums
    them. A negative id wraps once by +height; one still out of range is
    dropped, as the JAX scatters drop it."""
    rows = wrap_ids(rows.reshape(-1).long(), height)
    valid = (rows >= 0) & (rows < height)
    uniq, inv = torch.unique(rows[valid], return_inverse=True)
    merged = torch.zeros((uniq.shape[0],) + tuple(vals.shape[1:]),
                         dtype=torch.float32, device=vals.device)
    return uniq, merged.index_add_(0, inv, vals[valid].float())


@register_lowering("sgd", no_grad=True)
def _sgd(ctx, inputs, attrs):
    p, g = one(inputs, "Param"), one(inputs, "Grad")
    lr = one(inputs, "LearningRate").reshape(()).to(p.dtype)
    rows = one(inputs, "GradRows")
    if rows is not None:
        # duplicate ids fold into the scatter-add itself
        return {"ParamOut": [scatter_rows_(p.clone(), rows,
                                           -lr * g.to(p.dtype))]}
    return {"ParamOut": [p - lr * g.to(p.dtype)]}


@register_lowering("momentum", no_grad=True)
def _momentum(ctx, inputs, attrs):
    """v_out = mu * v + g and p_out = p - (lr * v_out) rounded to p's dtype
    (Nesterov: p - ((g + mu * v_out) * lr)), in the velocity's dtype."""
    p, g = one(inputs, "Param"), one(inputs, "Grad")
    v = one(inputs, "Velocity")
    lr = one(inputs, "LearningRate").reshape(()).to(v.dtype)
    gf = g.to(v.dtype)
    mu = attrs["mu"]
    v_out = mu * v + gf
    if attrs.get("use_nesterov", False):
        p_out = p - ((gf + mu * v_out) * lr).to(p.dtype)
    else:
        p_out = p - (lr * v_out).to(p.dtype)
    return {"ParamOut": [p_out], "VelocityOut": [v_out]}


def _momentum_run_key(op):
    """Momentum ops of one run share mu, use_nesterov and the learning-rate
    variable."""
    return (op.attrs["mu"], op.attrs.get("use_nesterov", False),
            tuple(op.inputs["LearningRate"]))


def _flat_cast(tensors, dtype):
    """The tensors cast to ``dtype`` in two launches (one concatenation, one
    cast), as views of the cast buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors]).to(dtype)
    return [c.view(t.shape) for c, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)]


@register_group_lowering("momentum", key=_momentum_run_key)
def _momentum_group(ctx, inputs, attrs):
    """A run of momentum ops at once, with ``_momentum``'s arithmetic: the
    ops are split by the dtypes of Param, Grad and Velocity, and each part
    updates with ``torch._foreach_*`` calls over its lists, the casts done
    on one concatenated buffer. Returns each op's outputs."""
    mu = attrs[0]["mu"]
    nesterov = attrs[0].get("use_nesterov", False)
    parts = {}
    for k, ins in enumerate(inputs):
        key = (ins["Param"][0].dtype, ins["Grad"][0].dtype,
               ins["Velocity"][0].dtype)
        parts.setdefault(key, []).append(k)
    outs = [None] * len(inputs)
    for (p_dtype, g_dtype, v_dtype), ks in parts.items():
        ps = [inputs[k]["Param"][0] for k in ks]
        gs = [inputs[k]["Grad"][0] for k in ks]
        vs = [inputs[k]["Velocity"][0] for k in ks]
        lr = inputs[ks[0]]["LearningRate"][0].reshape(()).to(v_dtype)
        if g_dtype != v_dtype:
            gs = _flat_cast(gs, v_dtype)
        v_out = torch._foreach_mul(vs, mu)
        torch._foreach_add_(v_out, gs)
        if nesterov:
            steps = torch._foreach_mul(v_out, mu)
            torch._foreach_add_(steps, gs)
            torch._foreach_mul_(steps, lr)
        else:
            steps = torch._foreach_mul(v_out, lr)
        if p_dtype != v_dtype:
            steps = _flat_cast(steps, p_dtype)
        p_out = torch._foreach_sub(ps, steps)
        for k, p, v in zip(ks, p_out, v_out):
            outs[k] = {"ParamOut": [p], "VelocityOut": [v]}
    return outs


def _adam_run_key(op):
    """Adam ops of one run share beta1, beta2 and epsilon and have no
    GradRows; an op with GradRows runs alone (``_adam``)."""
    if op.inputs.get("GradRows"):
        return None
    return (op.attrs.get("beta1", 0.9), op.attrs.get("beta2", 0.999),
            op.attrs.get("epsilon", 1e-8))


@register_group_lowering("adam", key=_adam_run_key)
def _adam_group(ctx, inputs, attrs):
    """A run of adam ops (lists of their inputs and attrs; the key above
    equal for all) at once. Returns each op's outputs."""
    b1 = attrs[0].get("beta1", 0.9)
    b2 = attrs[0].get("beta2", 0.999)
    eps = attrs[0].get("epsilon", 1e-8)
    ps = [one(i, "Param") for i in inputs]
    b1ps = [one(i, "Beta1Pow") for i in inputs]
    b2ps = [one(i, "Beta2Pow") for i in inputs]
    lrs = [one(i, "LearningRate") for i in inputs]
    # lr_t = lr * sqrt(1 - b2p) / (1 - b1p), each step rounded as the per-op
    # formula rounds it (1 - x as -x + 1 is the same f32 sum)
    one_minus_b2 = torch._foreach_neg(b2ps)
    torch._foreach_add_(one_minus_b2, 1.0)
    lr_ts = torch._foreach_sqrt(one_minus_b2)
    if all(lr is lrs[0] for lr in lrs):
        torch._foreach_mul_(lr_ts, lrs[0].reshape(()).float())
    else:
        torch._foreach_mul_(lr_ts, [lr.float() for lr in lrs])
    one_minus_b1 = torch._foreach_neg(b1ps)
    torch._foreach_add_(one_minus_b1, 1.0)
    torch._foreach_div_(lr_ts, one_minus_b1)
    b1p_out = torch._foreach_mul(b1ps, b1)
    b2p_out = torch._foreach_mul(b2ps, b2)

    outs, kernel = [], []
    for k, (ins, p, lr_t) in enumerate(zip(inputs, ps, lr_ts)):
        g = one(ins, "Grad")
        m1, m2 = one(ins, "Moment1"), one(ins, "Moment2")
        if _adam_kernel_ok(p):
            kernel.append(k)
            out = (p, m1, m2)      # updated in place by the launch below
        else:
            gf = g.float()
            m1_out = b1 * m1 + (1.0 - b1) * gf
            m2_out = b2 * m2 + (1.0 - b2) * torch.square(gf)
            out = (p - (lr_t * m1_out / (torch.sqrt(m2_out) + eps)).to(
                p.dtype), m1_out, m2_out)
        outs.append({"ParamOut": [out[0]], "Moment1Out": [out[1]],
                     "Moment2Out": [out[2]], "Beta1PowOut": [b1p_out[k]],
                     "Beta2PowOut": [b2p_out[k]]})
    if kernel:
        from ...ops.adam_kernel import adam_update_multi
        adam_update_multi([ps[k] for k in kernel],
                          [one(inputs[k], "Grad").contiguous()
                           for k in kernel],
                          [one(inputs[k], "Moment1") for k in kernel],
                          [one(inputs[k], "Moment2") for k in kernel],
                          [lr_ts[k] for k in kernel], b1, b2, eps)
    return outs


@register_lowering("adam", no_grad=True)
def _adam(ctx, inputs, attrs):
    rows = one(inputs, "GradRows")
    if rows is None:
        return _adam_group(ctx, [inputs], [attrs])[0]
    p, g = one(inputs, "Param"), one(inputs, "Grad")
    m1, m2 = one(inputs, "Moment1"), one(inputs, "Moment2")
    b1p, b2p = one(inputs, "Beta1Pow"), one(inputs, "Beta2Pow")
    lr = one(inputs, "LearningRate").reshape(()).float()
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr_t = lr * torch.sqrt(1.0 - b2p.reshape(())) / (1.0 - b1p.reshape(()))
    out = {"Beta1PowOut": [b1p * b1], "Beta2PowOut": [b2p * b2]}
    if attrs.get("lazy_mode"):
        # only the touched rows' moments decay and update
        r, gv = _merge_rows(rows, g, p.shape[0])
        m1_r = b1 * m1[r] + (1.0 - b1) * gv
        m2_r = b2 * m2[r] + (1.0 - b2) * torch.square(gv)
        step = (lr_t * m1_r / (torch.sqrt(m2_r) + eps)).to(p.dtype)
        m1_out, m2_out = m1.clone(), m2.clone()
        m1_out[r], m2_out[r] = m1_r, m2_r
        return dict(out, ParamOut=[p.index_add(0, r, -step)],
                    Moment1Out=[m1_out], Moment2Out=[m2_out])
    gf = scatter_rows_(torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device), rows, g)
    m1_out = b1 * m1 + (1.0 - b1) * gf
    m2_out = b2 * m2 + (1.0 - b2) * torch.square(gf)
    p_out = p - (lr_t * m1_out / (torch.sqrt(m2_out) + eps)).to(p.dtype)
    return dict(out, ParamOut=[p_out], Moment1Out=[m1_out],
                Moment2Out=[m2_out])
