"""Optimizer-update lowerings: sgd, momentum, lars_momentum, adam, adamax,
adagrad, decayed_adagrad, adadelta, rmsprop, ftrl, proximal_gd,
proximal_adagrad and ModelAverage's average_accumulates; sgd, adagrad and
adam dense and sparse (the port's counterpart of
``paddle_tpu/fluid/ops/optimizer_ops.py``). All are no-grad.

The optimizers after adam follow the JAX lowerings' arithmetic, including
its type promotion: where a bfloat16 parameter or accumulator meets the
float32 learning rate, JAX computes in float32, and so does the port (a
0-d float32 tensor would not promote a bfloat16 one in PyTorch). JAX then
hands back a float32 ParamOut (and, for rmsprop's Moment and ftrl's
LinearAccumulator, a float32 accumulator) for a bfloat16 variable; the
port rounds each output to its variable's dtype, so the program's
declared dtypes hold from step to step (ROADMAP Queue 3).

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
-lr * values into the touched rows; adagrad merges duplicate ids and
updates only the touched rows' moments and parameters, and so does adam
with ``lazy_mode``,
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


def _lr(inputs):
    return one(inputs, "LearningRate").reshape(())


def _promoted(lr, *tensors):
    """The dtype JAX computes ``lr * t`` in: float32 for a bfloat16 t and
    the float32 learning rate."""
    dtype = lr.dtype
    for t in tensors:
        dtype = torch.promote_types(dtype, t.dtype)
    return dtype


@register_lowering("lars_momentum", no_grad=True)
def _lars_momentum(ctx, inputs, attrs):
    """v_out = mu * v + local_lr * (g + decay * p), p_out = p - v_out, with
    local_lr = lr * coeff * |p| / max(|g| + decay * |p|, 1e-12), all in
    p's dtype (the learning rate cast to it)."""
    p, g = one(inputs, "Param"), one(inputs, "Grad")
    v = one(inputs, "Velocity")
    lr = _lr(inputs).to(p.dtype)
    mu = attrs["mu"]
    coeff = attrs.get("lars_coeff", 0.001)
    decay = attrs.get("lars_weight_decay", 0.0005)
    pn = torch.sqrt(torch.sum(torch.square(p)))
    gn = torch.sqrt(torch.sum(torch.square(g)))
    local_lr = lr * coeff * pn / torch.clamp(gn + decay * pn, min=1e-12)
    v_out = mu * v + local_lr * (g + decay * p)
    return {"ParamOut": [p - v_out], "VelocityOut": [v_out]}


@register_lowering("adamax", no_grad=True)
def _adamax(ctx, inputs, attrs):
    """m_out = b1 * m + (1 - b1) * g, inf_out = max(b2 * inf, |g|) (a tie
    keeps the value either way), p_out = p - lr / (1 - b1^t) * m_out /
    (inf_out + eps). Beta1Pow advances by the optimizer's scale op."""
    p, g = one(inputs, "Param"), one(inputs, "Grad")
    m, inf = one(inputs, "Moment"), one(inputs, "InfNorm")
    b1p = one(inputs, "Beta1Pow")
    lr = _lr(inputs)
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_out = b1 * m + (1.0 - b1) * g
    inf_out = torch.maximum(b2 * inf, torch.abs(g))
    lr_t = lr / (1.0 - b1p.reshape(()))
    ft = _promoted(lr_t, p, m_out)
    step = lr_t * m_out.to(ft) / (inf_out + eps).to(ft)
    return {"ParamOut": [(p.to(ft) - step).to(p.dtype)],
            "MomentOut": [m_out], "InfNormOut": [inf_out]}


@register_lowering("adagrad", no_grad=True)
def _adagrad(ctx, inputs, attrs):
    """m_out = m + g^2, p_out = p - lr * g / (sqrt(m_out) + eps). Sparse
    (GradRows): duplicate ids merged, only the touched rows' moments and
    parameters change."""
    p, g, m = one(inputs, "Param"), one(inputs, "Grad"), one(inputs, "Moment")
    lr = _lr(inputs)
    eps = attrs.get("epsilon", 1e-6)
    rows = one(inputs, "GradRows")
    if rows is not None:
        r, gv = _merge_rows(rows, g, p.shape[0])
        m_r = m[r].to(gv.dtype) + torch.square(gv)
        step = (lr * gv / (torch.sqrt(m_r) + eps)).to(p.dtype)
        m_out = m.clone()
        m_out[r] = m_r.to(m.dtype)
        return {"ParamOut": [p.index_add(0, r, -step)],
                "MomentOut": [m_out]}
    m_out = m + torch.square(g)
    ft = _promoted(lr, p, g)
    step = lr * g.to(ft) / (torch.sqrt(m_out) + eps).to(ft)
    return {"ParamOut": [(p.to(ft) - step).to(p.dtype)],
            "MomentOut": [m_out]}


@register_lowering("decayed_adagrad", no_grad=True)
def _decayed_adagrad(ctx, inputs, attrs):
    p, g, m = one(inputs, "Param"), one(inputs, "Grad"), one(inputs, "Moment")
    lr = _lr(inputs)
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    m_out = decay * m + (1.0 - decay) * torch.square(g)
    ft = _promoted(lr, p, g)
    step = lr * g.to(ft) / (torch.sqrt(m_out) + eps).to(ft)
    return {"ParamOut": [(p.to(ft) - step).to(p.dtype)],
            "MomentOut": [m_out]}


@register_lowering("adadelta", no_grad=True)
def _adadelta(ctx, inputs, attrs):
    """No learning rate: update = -sqrt((E[u^2] + eps) / (E[g^2] + eps)) *
    g, in the variables' dtype."""
    p, g = one(inputs, "Param"), one(inputs, "Grad")
    avg_sq_g = one(inputs, "AvgSquaredGrad")
    avg_sq_u = one(inputs, "AvgSquaredUpdate")
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    asg_out = rho * avg_sq_g + (1.0 - rho) * torch.square(g)
    update = -torch.sqrt((avg_sq_u + eps) / (asg_out + eps)) * g
    asu_out = rho * avg_sq_u + (1.0 - rho) * torch.square(update)
    return {"ParamOut": [p + update], "AvgSquaredGradOut": [asg_out],
            "AvgSquaredUpdateOut": [asu_out]}


@register_lowering("rmsprop", no_grad=True)
def _rmsprop(ctx, inputs, attrs):
    """ms_out = rho * ms + (1 - rho) * g^2; centered, also mg_out = rho *
    mg + (1 - rho) * g and the denominator ms_out - mg_out^2 + eps (else
    ms_out + eps); mom_out = momentum * mom + lr * g / sqrt(denominator),
    p_out = p - mom_out."""
    p, g = one(inputs, "Param"), one(inputs, "Grad")
    ms, mom = one(inputs, "MeanSquare"), one(inputs, "Moment")
    mg = one(inputs, "MeanGrad")
    lr = _lr(inputs)
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    momentum = attrs.get("momentum", 0.0)
    ms_out = rho * ms + (1.0 - rho) * torch.square(g)
    if attrs.get("centered", False):
        mg_out = rho * mg + (1.0 - rho) * g
        denom = ms_out - torch.square(mg_out) + eps
    else:
        mg_out = mg
        denom = ms_out + eps
    ft = _promoted(lr, p, mom, g)
    mom_out = (momentum * mom).to(ft) + \
        lr * g.to(ft) / torch.sqrt(denom).to(ft)
    out = {"ParamOut": [(p.to(ft) - mom_out).to(p.dtype)],
           "MeanSquareOut": [ms_out], "MomentOut": [mom_out.to(mom.dtype)]}
    if mg is not None:
        out["MeanGradOut"] = [mg_out]
    return out


@register_lowering("ftrl", no_grad=True)
def _ftrl(ctx, inputs, attrs):
    """FTRL-proximal: new_sq = sq + g^2, sigma = (new_sq^-power -
    sq^-power) / lr (sqrt for the default power -0.5), lin_out = lin + g -
    sigma * p, p_out = (clip(lin_out, -l1, l1) - lin_out) / (new_sq^-power
    / lr + 2 * l2) where |lin_out| > l1, else 0."""
    p, g = one(inputs, "Param"), one(inputs, "Grad")
    sq = one(inputs, "SquaredAccumulator")
    lin = one(inputs, "LinearAccumulator")
    lr = _lr(inputs)
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    power = attrs.get("lr_power", -0.5)
    new_sq = sq + torch.square(g)
    if power == -0.5:
        root_new, root_old = torch.sqrt(new_sq), torch.sqrt(sq)
    else:
        root_new, root_old = torch.pow(new_sq, -power), torch.pow(sq, -power)
    ft = _promoted(lr, p, lin, new_sq)
    sigma = (root_new - root_old).to(ft) / lr
    lin_out = (lin + g).to(ft) - sigma * p.to(ft)
    denom = root_new.to(ft) / lr + 2.0 * l2
    pre = torch.clamp(lin_out, -l1, l1) - lin_out
    p_out = torch.where(torch.abs(lin_out) > l1, pre / denom,
                        torch.zeros_like(lin_out))
    return {"ParamOut": [p_out.to(p.dtype)], "SquaredAccumOut": [new_sq],
            "LinearAccumOut": [lin_out.to(lin.dtype)]}


def _proximal(p, g, lr_t, l1, l2):
    """sign(prox) * max(|prox| - lr_t * l1, 0) / (1 + lr_t * l2) for prox =
    p - lr_t * g, in the promoted dtype, rounded to p's."""
    ft = _promoted(lr_t, p, g)
    prox = p.to(ft) - lr_t * g.to(ft)
    return (torch.sign(prox) * torch.clamp(torch.abs(prox) - lr_t * l1,
                                           min=0.0) /
            (1.0 + lr_t * l2)).to(p.dtype)


@register_lowering("proximal_gd", no_grad=True)
def _proximal_gd(ctx, inputs, attrs):
    p, g = one(inputs, "Param"), one(inputs, "Grad")
    return {"ParamOut": [_proximal(p, g, _lr(inputs), attrs.get("l1", 0.0),
                                   attrs.get("l2", 0.0))]}


@register_lowering("proximal_adagrad", no_grad=True)
def _proximal_adagrad(ctx, inputs, attrs):
    """m_out = m + g^2, then proximal_gd's step at lr / sqrt(m_out)."""
    p, g, m = one(inputs, "Param"), one(inputs, "Grad"), one(inputs, "Moment")
    lr = _lr(inputs)
    m_out = m + torch.square(g)
    lr_t = lr / torch.sqrt(m_out).to(_promoted(lr, m_out))
    return {"ParamOut": [_proximal(p, g, lr_t, attrs.get("l1", 0.0),
                                   attrs.get("l2", 0.0))],
            "MomentOut": [m_out]}


@register_lowering("average_accumulates", no_grad=True)
def _average_accumulates(ctx, inputs, attrs):
    """ModelAverage's window bookkeeping, on the device: sum_1 gathers the
    parameter each step; past the window (clamped between
    min_average_window and max_average_window, else num_updates *
    average_window) sum_1 rolls into sum_2, and sum_2 into sum_3."""
    param = one(inputs, "param")
    sum_1 = one(inputs, "in_sum_1")
    sum_2 = one(inputs, "in_sum_2")
    sum_3 = one(inputs, "in_sum_3")
    num_accum = one(inputs, "in_num_accumulates") + 1
    old_num = one(inputs, "in_old_num_accumulates")
    num_updates = one(inputs, "in_num_updates") + 1
    avg_window = attrs.get("average_window", 0.15)
    max_avg = attrs.get("max_average_window", 10000)
    min_avg = attrs.get("min_average_window", 10000)
    sum_1 = sum_1 + param
    window = (num_updates.float() * avg_window).long()
    window = torch.minimum(window.new_tensor(max_avg),
                           torch.maximum(window.new_tensor(min_avg), window))
    roll = num_accum > window
    sum_2_n = torch.where(roll, sum_2 + sum_1, sum_2)
    sum_1_n = torch.where(roll, torch.zeros_like(sum_1), sum_1)
    old_num_n = torch.where(roll, num_accum, old_num)
    num_accum_n = torch.where(roll, torch.zeros_like(num_accum), num_accum)
    roll2 = old_num_n + num_accum_n > window
    sum_3_n = torch.where(roll2, sum_2_n, sum_3)
    sum_2_n = torch.where(roll2, torch.zeros_like(sum_2_n), sum_2_n)
    return {"out_sum_1": [sum_1_n], "out_sum_2": [sum_2_n],
            "out_sum_3": [sum_3_n], "out_num_accumulates": [num_accum_n],
            "out_old_num_accumulates": [old_num_n],
            "out_num_updates": [num_updates]}
