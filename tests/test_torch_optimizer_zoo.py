"""Every Fluid optimizer the JAX package has, in the port, against the JAX
package on the CPU: the ten update lowerings this slice adds (lars_momentum,
adamax, adagrad dense and sparse, decayed_adagrad, adadelta, rmsprop plain,
with momentum and centered, ftrl at lr_power -0.5 and -0.7, proximal_gd,
proximal_adagrad, average_accumulates), each optimizer class's program op
for op (types, slots, attributes, startup accumulators), three steps of a
small MLP against the JAX executor with the weights carried by
``params_from_numpy``, and ModelAverage's apply and restore.

Tolerances. float32 updates and steps: |got - want| <= 1e-5 * |want| +
1e-7 (assert_allclose), as tests/test_torch_optimizer.py (sums in other
orders; the division and square roots of the updates keep the error near
an ulp). Counters (int64 in the port, int32 in the JAX package without x64)
and ModelAverage's float64 averages must be equal. bfloat16 parameters:
where JAX promotes ``bf16 p - f32 lr * g`` to float32 and hands back a
float32 ParamOut, the port rounds it to bfloat16 (ROADMAP Queue 3); the
port's output must lie within one bf16 ulp (2^-7 relative) plus 2^-8 of
the largest value of the JAX output (the bf16 accumulators round each
operation in PyTorch, and XLA may keep float32 between them; centered
RMSProp's mean square minus squared mean cancels in bf16, and reads up to
0.0019 of the largest value).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid.ops import registry as jreg
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid.ops import registry as treg


def _rng(seed):
    return np.random.RandomState(seed)


def _f32(*shape, seed=0, scale=1.0):
    return (_rng(seed).randn(*shape) * scale).astype(np.float32)


def _pos(*shape, seed=0, scale=0.1):
    return (np.abs(_rng(seed).randn(*shape)) * scale + 0.01).astype(
        np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        x = x.float() if x.dtype == torch.bfloat16 else x
        return x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


SHAPE = (6, 5)
# op -> (the float inputs: slot -> maker(seed), the attrs); Param, Grad and
# LearningRate come with every op but average_accumulates
UPDATES = {
    "lars_momentum": ({"Velocity": lambda s: _f32(*SHAPE, seed=s,
                                                  scale=0.01)},
                      {"mu": 0.9, "lars_coeff": 0.002,
                       "lars_weight_decay": 0.001}),
    "adamax": ({"Moment": lambda s: _f32(*SHAPE, seed=s, scale=0.1),
                "InfNorm": lambda s: _pos(*SHAPE, seed=s),
                "Beta1Pow": lambda s: np.array([0.81], np.float32)},
               {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "adagrad": ({"Moment": lambda s: _pos(*SHAPE, seed=s)},
                {"epsilon": 1e-6}),
    "decayed_adagrad": ({"Moment": lambda s: _pos(*SHAPE, seed=s)},
                        {"decay": 0.9, "epsilon": 1e-6}),
    "adadelta": ({"AvgSquaredGrad": lambda s: _pos(*SHAPE, seed=s),
                  "AvgSquaredUpdate": lambda s: _pos(*SHAPE, seed=s + 1)},
                 {"rho": 0.9, "epsilon": 1e-6}),
    "rmsprop": ({"MeanSquare": lambda s: _pos(*SHAPE, seed=s, scale=1.0),
                 "Moment": lambda s: _f32(*SHAPE, seed=s, scale=0.01),
                 "MeanGrad": lambda s: _f32(*SHAPE, seed=s + 1, scale=0.1)},
                {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.0,
                 "centered": False}),
    "ftrl": ({"SquaredAccumulator": lambda s: _pos(*SHAPE, seed=s),
              "LinearAccumulator": lambda s: _f32(*SHAPE, seed=s,
                                                  scale=0.1)},
             {"l1": 0.01, "l2": 0.02, "lr_power": -0.5}),
    "proximal_gd": ({}, {"l1": 0.01, "l2": 0.02}),
    "proximal_adagrad": ({"Moment": lambda s: _pos(*SHAPE, seed=s)},
                         {"l1": 0.01, "l2": 0.02}),
    "average_accumulates": (
        {"in_sum_1": lambda s: _f32(*SHAPE, seed=s),
         "in_sum_2": lambda s: _f32(*SHAPE, seed=s + 1),
         "in_sum_3": lambda s: _f32(*SHAPE, seed=s + 2)},
        {"average_window": 0.5, "min_average_window": 2,
         "max_average_window": 3}),
}
# variants of the same lowerings
VARIANTS = {
    "rmsprop_momentum": ("rmsprop", {"momentum": 0.9}),
    "rmsprop_centered": ("rmsprop", {"momentum": 0.5, "centered": True}),
    "ftrl_power": ("ftrl", {"lr_power": -0.7}),
    "ftrl_no_l1": ("ftrl", {"l1": 0.0}),
}
# the ops whose JAX lowering hands back a float32 ParamOut for a bfloat16
# parameter (lars_momentum casts lr to p's dtype; adadelta has no lr)
PROMOTING = {"adamax", "adagrad", "decayed_adagrad", "rmsprop", "ftrl",
             "proximal_gd", "proximal_adagrad"}


def _update_inputs(op, attrs, seed, counts=(3, 1, 4)):
    """{slot: [numpy]} for one call of an update lowering."""
    makers = UPDATES[op][0]
    ins = {slot: [make(seed + 10 * k)]
           for k, (slot, make) in enumerate(sorted(makers.items()))}
    if op == "average_accumulates":
        ins["param"] = [_f32(*SHAPE, seed=seed + 7)]
        for slot, n in zip(("in_num_accumulates", "in_old_num_accumulates",
                            "in_num_updates"), counts):
            ins[slot] = [np.array([n], np.int64)]
        return ins
    ins["Param"] = [_f32(*SHAPE, seed=seed + 7)]
    ins["Grad"] = [_f32(*SHAPE, seed=seed + 8, scale=0.5)]
    ins["LearningRate"] = [np.array([0.05], np.float32)]
    return ins


def _run(op, ins, attrs, bf16=()):
    """The JAX and the port lowering on the same inputs, the slots of
    ``bf16`` in bfloat16."""
    def j(slot, a):
        a = jnp.asarray(a)
        return a.astype(jnp.bfloat16) if slot in bf16 else a

    def t(slot, a):
        a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(torch.bfloat16) if slot in bf16 else a
    want = jreg.get_lowering(op)(
        jreg.LoweringContext(), {k: [j(k, a) for a in v]
                                 for k, v in ins.items()}, attrs)
    got = treg.get_lowering(op)(
        treg.LoweringContext("cpu"), {k: [t(k, a) for a in v]
                                      for k, v in ins.items()}, attrs)
    return want, got


CASES = dict({op: (op, {}) for op in UPDATES}, **VARIANTS)


def test_the_cases_are_the_ported_update_lowerings():
    assert len(UPDATES) == 10
    assert all(treg.has_lowering(op) and treg.is_no_grad(op)
               for op in UPDATES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_update_matches_jax(case):
    op, extra = CASES[case]
    attrs = dict(UPDATES[op][1], **extra)
    ins = _update_inputs(op, attrs, seed=3)
    want, got = _run(op, ins, attrs)
    assert set(got) == set(want)
    for slot in want:
        w, g = _np(want[slot][0]), _np(got[slot][0])
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=slot)
        else:
            assert g.dtype == np.float32, slot
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7,
                                       err_msg=slot)


@pytest.mark.parametrize("counts", [(1, 0, 1), (2, 1, 5), (3, 2, 9),
                                    (0, 4, 20)])
def test_average_accumulates_rolls_its_window_as_jax(counts):
    """The window's two roll-overs (sum_1 into sum_2, sum_2 into sum_3)
    at counts on both sides of the window."""
    attrs = UPDATES["average_accumulates"][1]
    want, got = _run("average_accumulates",
                     _update_inputs("average_accumulates", attrs, 5, counts),
                     attrs)
    for slot in want:
        np.testing.assert_allclose(_np(got[slot][0]), _np(want[slot][0]),
                                   rtol=1e-6, atol=0, err_msg=slot)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_update_keeps_the_declared_dtype(case):
    """A bfloat16 parameter, gradient and accumulators (the optimizers'
    default accumulator dtype is the parameter's; ModelAverage's sums are
    float32): the port hands back every output in its input's dtype; the
    JAX lowering hands back a float32 ParamOut for the ops of PROMOTING
    (and float32 rmsprop MomentOut, ftrl LinearAccumOut). Values: the port
    within a bf16 rounding of the JAX output."""
    op, extra = CASES[case]
    attrs = dict(UPDATES[op][1], **extra)
    ins = _update_inputs(op, attrs, seed=4)
    bf16 = {k for k in ins if k not in ("LearningRate", "in_sum_1",
                                        "in_sum_2", "in_sum_3") and
            ins[k][0].dtype == np.float32}
    want, got = _run(op, ins, attrs, bf16)
    out_of = {"ParamOut": "Param", "MomentOut": "Moment",
              "LinearAccumOut": "LinearAccumulator"}
    for slot in want:
        g, w = got[slot][0], want[slot][0]
        src = out_of.get(slot)
        if src in bf16:
            assert g.dtype == torch.bfloat16, slot
        if slot == "ParamOut":
            assert (w.dtype == jnp.float32) == (op in PROMOTING), slot
        gn, wn = _np(g).astype(np.float64), _np(w).astype(np.float64)
        bound = 2.0 ** -7 * np.abs(wn) + 2.0 ** -8 * np.abs(wn).max()
        assert (np.abs(gn - wn) <= bound).all(), (slot, np.abs(gn - wn).max())


# --------------------------------------------------------------------------
# the optimizer classes: programs and steps against the JAX executor
# --------------------------------------------------------------------------

def _signature(program):
    return [(op.type, dict(op.inputs), dict(op.outputs),
             sorted((k, repr(v)) for k, v in op.attrs.items()))
            for op in program.global_block().ops]


# name -> (the update op type, the optimizer)
OPTIMIZERS = {
    "lars_momentum": ("lars_momentum", lambda fl: fl.optimizer.LarsMomentum(
        0.1, 0.9, lars_coeff=0.01, lars_weight_decay=0.001)),
    "adagrad": ("adagrad", lambda fl: fl.optimizer.Adagrad(0.1)),
    "adagrad_initial": ("adagrad", lambda fl: fl.optimizer.AdagradOptimizer(
        0.1, epsilon=1e-5, initial_accumulator_value=0.1)),
    "adamax": ("adamax", lambda fl: fl.optimizer.Adamax(0.05, beta1=0.8,
                                                        beta2=0.99)),
    "decayed_adagrad": ("decayed_adagrad",
                        lambda fl: fl.optimizer.DecayedAdagrad(0.05)),
    "adadelta": ("adadelta", lambda fl: fl.optimizer.Adadelta(1.0, rho=0.9)),
    "rmsprop": ("rmsprop", lambda fl: fl.optimizer.RMSProp(0.01)),
    "rmsprop_momentum": ("rmsprop", lambda fl: fl.optimizer.RMSPropOptimizer(
        0.01, momentum=0.9)),
    "rmsprop_centered": ("rmsprop", lambda fl: fl.optimizer.RMSProp(
        0.01, momentum=0.5, centered=True)),
    "ftrl": ("ftrl", lambda fl: fl.optimizer.Ftrl(0.1, l1=0.001, l2=0.01)),
    "ftrl_power": ("ftrl", lambda fl: fl.optimizer.FtrlOptimizer(
        0.1, l1=0.001, l2=0.01, lr_power=-0.7)),
    "adamax_l2": ("adamax", lambda fl: fl.optimizer.Adamax(
        0.05, regularization=fl.regularizer.L2Decay(0.01))),
}


def _mlp(fl, opt, sparse=False):
    """x [6] -> fc 5 relu -> fc 3 -> mean(0.5 y), or with ``sparse`` an
    is_sparse embedding [20, 6] of 3 ids a row summed into x."""
    main, startup = fl.Program(), fl.Program()
    startup.random_seed = 5
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        if sparse:
            ids = fl.layers.data(name="ids", shape=[3, 1], dtype="int64")
            emb = fl.layers.embedding(ids, size=[20, 6], is_sparse=True,
                                      param_attr=fl.ParamAttr(name="emb"))
            x = fl.layers.reduce_sum(emb, dim=1)
        else:
            x = fl.layers.data(name="x", shape=[6], dtype="float32")
        h = fl.layers.fc(input=x, size=5, act="relu",
                         param_attr=fl.ParamAttr(name="h.w"))
        y = fl.layers.fc(input=h, size=3, param_attr=fl.ParamAttr(name="y.w"))
        loss = fl.layers.mean(fl.layers.scale(y, scale=0.5))
        o = opt(fl)
        o.minimize(loss)
    return main, startup, loss, o


def _feed(sparse, step):
    rng = _rng(20 + step)
    if sparse:
        # repeated ids in a batch: the sparse update merges them
        return {"ids": rng.randint(0, 8, (4, 3, 1)).astype(np.int64)}
    return {"x": rng.randn(4, 6).astype(np.float32)}


def _pair(opt, sparse=False):
    j, t = _mlp(jfluid, opt, sparse), _mlp(tfluid, opt, sparse)
    assert _signature(j[0]) == _signature(t[0])
    assert _signature(j[1]) == _signature(t[1])
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    jexe.run(j[1], scope=jscope)
    texe.run(t[1], scope=tscope)
    names = [v.name for v in j[0].global_block().vars.values()
             if v.persistable and jscope.get(v.name) is not None]
    tfluid.params_from_numpy({n: np.asarray(jscope.get(n)) for n in names},
                             tscope, "cpu")
    return (j, jexe, jscope), (t, texe, tscope), names


def _steps_match(jside, tside, names, sparse=False, steps=3):
    (j, jexe, jscope), (t, texe, tscope) = jside, tside
    for step in range(steps):
        feed = _feed(sparse, step)
        want, = jexe.run(j[0], feed=feed, fetch_list=[j[2]], scope=jscope)
        got, = texe.run(t[0], feed=feed, fetch_list=[t[2]], scope=tscope)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                   err_msg="loss, step %d" % step)
    for n in names:
        np.testing.assert_allclose(_np(tscope.get(n)),
                                   np.asarray(jscope.get(n)), rtol=1e-5,
                                   atol=1e-7, err_msg=n)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_program_and_three_steps_match_jax(name):
    op_type, opt = OPTIMIZERS[name]
    jside, tside, names = _pair(opt)
    ops = [op for op in tside[0][0].global_block().ops
           if op.type == op_type]
    assert len(ops) == 4          # one update op a parameter
    _steps_match(jside, tside, names)


def test_sparse_adagrad_matches_jax():
    """An is_sparse embedding's (values, rows) gradient goes to adagrad's
    sparse route (GradRows), which merges repeated ids and moves only the
    touched rows."""
    jside, tside, names = _pair(OPTIMIZERS["adagrad"][1], sparse=True)
    (t, texe, tscope) = tside
    ops = [op for op in t[0].global_block().ops if op.type == "adagrad"]
    assert [bool(op.input("GradRows")) for op in ops].count(True) == 1
    before = _np(tscope.get("emb")).copy()
    _steps_match(jside, tside, names, sparse=True)
    touched = np.unique(np.concatenate(
        [_feed(True, s)["ids"].reshape(-1) for s in range(3)]))
    untouched = np.setdiff1d(np.arange(20), touched)
    np.testing.assert_array_equal(_np(tscope.get("emb"))[untouched],
                                  before[untouched])


def test_every_optimizer_has_its_long_and_short_name():
    for short, long_ in [("SGD", "SGDOptimizer"),
                         ("Momentum", "MomentumOptimizer"),
                         ("LarsMomentum", "LarsMomentumOptimizer"),
                         ("Adagrad", "AdagradOptimizer"),
                         ("Adam", "AdamOptimizer"),
                         ("Adamax", "AdamaxOptimizer"),
                         ("DecayedAdagrad", "DecayedAdagradOptimizer"),
                         ("Adadelta", "AdadeltaOptimizer"),
                         ("RMSProp", "RMSPropOptimizer"),
                         ("Ftrl", "FtrlOptimizer")]:
        assert getattr(tfluid.optimizer, short) is \
            getattr(tfluid.optimizer, long_)
        assert hasattr(jfluid.optimizer, short)
    assert set(jfluid.optimizer.__all__) <= set(tfluid.optimizer.__all__)
    assert tfluid.optimizer.ModelAverage


def test_adamax_advances_beta1_pow_by_scale_ops():
    """Adamax's Beta1Pow advances through one scale op a parameter after
    the update ops (_finish_update), as in the JAX package."""
    jside, tside, names = _pair(OPTIMIZERS["adamax"][1])
    ops = tside[0][0].global_block().ops
    scales = [op for op in ops if op.type == "scale" and
              op.input("X")[0].endswith("beta1_pow_acc_acc_0")]
    assert len(scales) == 4 and all(op.attr("scale") == 0.8
                                    for op in scales)
    _steps_match(jside, tside, names, steps=2)
    b1p = [n for n in names if "beta1_pow" in n]
    for n in b1p:
        np.testing.assert_allclose(_np(tside[2].get(n)), [0.8 ** 3],
                                   rtol=1e-6)


def test_bf16_parameters_stay_bf16_through_rmsprop_steps():
    """The port keeps a bfloat16 parameter bfloat16 after an optimizer that
    JAX promotes (ROADMAP Queue 3), so the next step's bf16 matmul runs."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[6], dtype="bfloat16")
        y = tfluid.layers.fc(input=x, size=3,
                             param_attr=tfluid.ParamAttr(name="w"))
        loss = tfluid.layers.mean(y)
        tfluid.optimizer.RMSProp(0.01, momentum=0.9).minimize(loss)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    feed = {"x": np.stack([_f32(4, 6, seed=s) for s in range(3)])}
    losses, = exe.run_steps(main, feed=feed, n_steps=3, fetch_list=[loss],
                            scope=scope)
    assert np.isfinite(losses).all()
    assert scope.get("w").dtype == torch.bfloat16
    assert scope.get("w_momentum_acc_0").dtype == torch.bfloat16


# --------------------------------------------------------------------------
# ModelAverage
# --------------------------------------------------------------------------

def _model_average(fl):
    main, startup, loss, _ = _mlp(fl, lambda f: f.optimizer.SGD(0.1))
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        ma = fl.optimizer.ModelAverage(0.5, min_average_window=2,
                                       max_average_window=3)
        ma.build()
    return main, startup, loss, ma


def test_model_average_apply_and_restore_match_jax():
    """Five SGD steps with ModelAverage's accumulate ops: the sums and
    counts match the JAX executor's; apply() puts the averages (summed
    and divided in float64) in the parameters' place, equal to the JAX
    package's, and restore() puts the very tensors it took back."""
    j, t = _model_average(jfluid), _model_average(tfluid)
    assert _signature(j[0]) == _signature(t[0])
    assert _signature(j[1]) == _signature(t[1])
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    jexe.run(j[1], scope=jscope)
    texe.run(t[1], scope=tscope)
    names = [v.name for v in j[0].global_block().vars.values()
             if v.persistable and jscope.get(v.name) is not None]
    tfluid.params_from_numpy({n: np.asarray(jscope.get(n)) for n in names},
                             tscope, "cpu")
    for step in range(5):
        feed = _feed(False, step)
        jexe.run(j[0], feed=feed, fetch_list=[j[2]], scope=jscope)
        texe.run(t[0], feed=feed, fetch_list=[t[2]], scope=tscope)
    for n in names:
        np.testing.assert_allclose(_np(tscope.get(n)),
                                   np.asarray(jscope.get(n)), rtol=1e-5,
                                   atol=1e-7, err_msg=n)
    params = [p.name for p in t[0].all_parameters()]
    trained = {n: tscope.get(n) for n in params}
    with jfluid.scope_guard(jscope):
        j[3].apply(jexe)
    with tfluid.scope_guard(tscope):
        t[3].apply(texe)
    for n in params:
        assert tscope.get(n) is not trained[n]
        np.testing.assert_allclose(_np(tscope.get(n)),
                                   np.asarray(jscope.get(n)), rtol=1e-6,
                                   atol=0, err_msg=n)
    # the average of what the window holds, computed here in float64
    n0 = params[0]
    sums = sum(_np(tscope.get("%s_sum_%d_acc_0" % (n0, k))).astype(
        np.float64) for k in (1, 2, 3))
    count = int(_np(tscope.get(n0 + "_num_accumulates_acc_0"))[0] +
                _np(tscope.get(n0 + "_old_num_accumulates_acc_0"))[0])
    np.testing.assert_array_equal(_np(tscope.get(n0)),
                                  (sums / count).astype(np.float32))
    with tfluid.scope_guard(tscope):
        t[3].restore(texe)
    for n in params:
        assert tscope.get(n) is trained[n]
