"""The learning-rate schedules (fluid.layers.*_decay, linear_lr_warmup,
append_LARS) in the port against the JAX package on the CPU: each
schedule's program is op for op the JAX package's, and the rate fetched
over 12 steps through Executor.run and through run_steps matches the JAX
executor's and the schedule's closed form (float64 on the host) within
1e-6 relative (a few float32 ulps of the pow, exp and cos on the step).
The step counter @LR_DECAY_COUNTER@ must hold the count of steps run (the
JAX package holds it as int32 without x64; the values are compared).
"""
import math

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import executor as texecutor

STEPS = 12
REL = 1e-6
COUNTER = "@LR_DECAY_COUNTER@"


def _noam(s, d=64, warm=4):
    return 2.0 * d ** -0.5 * min(s ** -0.5, s * warm ** -1.5)


def _poly(s, lr=0.1, steps=5, end=0.001, power=2.0, cycle=False):
    if cycle:
        decay = math.ceil(s / steps) * steps
        frac = s / decay if decay else float("nan")
    else:
        frac = min(s / steps, 1.0)
    return (lr - end) * (1.0 - frac) ** power + end


# name -> (the schedule built on fluid.layers, its closed form at step s
# (counted from the counter's first value), the counter's first value)
SCHEDULES = {
    "noam": (lambda L: L.noam_decay(64, 4) * 2.0, _noam, 1),
    "exponential": (lambda L: L.exponential_decay(0.1, 3, 0.5),
                    lambda s: 0.1 * 0.5 ** (s / 3), 0),
    "exponential_staircase": (
        lambda L: L.exponential_decay(0.1, 3, 0.5, staircase=True),
        lambda s: 0.1 * 0.5 ** (s // 3), 0),
    "natural_exp": (lambda L: L.natural_exp_decay(0.1, 3, 0.5),
                    lambda s: 0.1 * math.exp(-0.5 * s / 3), 0),
    "natural_exp_staircase": (
        lambda L: L.natural_exp_decay(0.1, 3, 0.5, staircase=True),
        lambda s: 0.1 * math.exp(-0.5 * (s // 3)), 0),
    "inverse_time": (lambda L: L.inverse_time_decay(0.1, 3, 0.5),
                     lambda s: 0.1 / (1.0 + 0.5 * s / 3), 0),
    "inverse_time_staircase": (
        lambda L: L.inverse_time_decay(0.1, 3, 0.5, staircase=True),
        lambda s: 0.1 / (1.0 + 0.5 * (s // 3)), 0),
    "polynomial": (lambda L: L.polynomial_decay(0.1, 5, 0.001, power=2.0),
                   _poly, 0),
    "polynomial_cycle": (
        lambda L: L.polynomial_decay(0.1, 5, 0.001, power=2.0, cycle=True),
        lambda s: _poly(s, cycle=True), 0),
    "piecewise": (lambda L: L.piecewise_decay([3, 6, 9],
                                              [0.1, 0.05, 0.01, 0.005]),
                  lambda s: [0.1, 0.05, 0.01, 0.005][
                      sum(s >= b for b in (3, 6, 9))], 0),
    "cosine": (lambda L: L.cosine_decay(0.1, 2, 6),
               lambda s: 0.1 * 0.5 * (math.cos((s // 2) * math.pi / 6) +
                                      1.0), 0),
    "linear_warmup": (lambda L: L.linear_lr_warmup(0.1, 5, 0.01, 0.1),
                      lambda s: 0.01 + 0.09 * min(s / 5, 1.0)
                      if s < 5 else 0.1, 0),
}


def _program(fl, schedule):
    """x [4] -> fc 1 -> mean, SGD at the schedule's rate."""
    main, startup = fl.Program(), fl.Program()
    startup.random_seed = 3
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[4], dtype="float32")
        loss = fl.layers.mean(fl.layers.fc(input=x, size=1))
        lr = schedule(fl.layers)
        fl.optimizer.SGD(learning_rate=lr).minimize(loss)
    return main, startup, loss, lr


def _signature(program):
    return [(op.type, dict(op.inputs), dict(op.outputs),
             sorted((k, repr(v)) for k, v in op.attrs.items()))
            for op in program.global_block().ops]


def _feeds():
    return [{"x": np.random.RandomState(s).randn(2, 4).astype(np.float32)}
            for s in range(STEPS)]


def _jax_rates(schedule):
    main, startup, _, lr = _program(jfluid, schedule)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe.run(startup, scope=scope)
    rates = [float(np.asarray(exe.run(main, feed=f, fetch_list=[lr],
                                      scope=scope)[0]).reshape(-1)[0])
             for f in _feeds()]
    return main, startup, rates, int(np.asarray(scope.get(COUNTER))[0])


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=REL, atol=0, err_msg=what)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax_through_run_and_run_steps(name):
    schedule, closed, first = SCHEDULES[name]
    jm, js, want, jcount = _jax_rates(schedule)
    tm, ts, _, lr = _program(tfluid, schedule)
    assert _signature(tm) == _signature(jm)
    assert _signature(ts) == _signature(js)
    assert tm.global_block().ops[0].type == "increment"
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(ts, scope=scope)
    by_run = [float(exe.run(tm, feed=f, fetch_list=[lr],
                            scope=scope)[0].reshape(-1)[0])
              for f in _feeds()]
    counter = scope.get(COUNTER)
    assert counter.dtype.is_floating_point is False
    assert int(counter[0]) == jcount == first + STEPS - 1
    steps_scope = tfluid.Scope()
    exe.run(ts, scope=steps_scope)
    stacked = {"x": np.stack([f["x"] for f in _feeds()])}
    by_steps, = exe.run_steps(tm, feed=stacked, n_steps=STEPS,
                              fetch_list=[lr], scope=steps_scope)
    assert int(steps_scope.get(COUNTER)[0]) == first + STEPS - 1
    _close(by_run, want, "run vs JAX")
    _close(by_steps.reshape(-1), want, "run_steps vs JAX")
    if name == "polynomial_cycle":
        # step 0: ceil(0) = 0 divides by zero in both packages
        assert math.isnan(by_run[0]) and math.isnan(want[0])
        by_run, want = by_run[1:], want[1:]
        first += 1
    _close(by_run, [closed(first + s) for s in range(len(by_run))],
           "closed form")


def test_the_schedules_are_the_jax_packages():
    assert set(jfluid.layers.learning_rate_scheduler.__all__) == \
        set(tfluid.layers.learning_rate_scheduler.__all__)
    assert {n.split("_staircase")[0].split("_cycle")[0] for n in SCHEDULES} \
        >= {"noam", "exponential", "natural_exp", "inverse_time",
            "polynomial", "piecewise", "cosine", "linear_warmup"}


def test_schedule_runs_on_the_device_with_no_host_op():
    """The rate is ops on the device: no host op in the program, every op
    of the schedule kept by run_steps' plan (which refuses host ops)."""
    tm, _, loss, lr = _program(tfluid, SCHEDULES["noam"][0])
    plan = texecutor._Plan(tm, [loss.name, lr.name], steps=True)
    kept = [op for op, _ in plan.steps]
    assert kept[0].type == "increment"
    assert {"elementwise_pow", "elementwise_min", "cast", "sgd"} <= \
        {op.type for op in kept}


def test_warmup_over_a_schedule_advances_the_counter_twice():
    """linear_lr_warmup over another schedule: each builds the step counter,
    so two increment ops run a step, as in the JAX package."""
    def schedule(L):
        return L.linear_lr_warmup(L.exponential_decay(0.1, 2, 0.5), 4,
                                  0.0, 0.1)
    jm, js, want, jcount = _jax_rates(schedule)
    tm, ts, _, lr = _program(tfluid, schedule)
    assert _signature(tm) == _signature(jm)
    assert [op.type for op in tm.global_block().ops[:2]] == \
        ["increment", "increment"]
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(ts, scope=scope)
    got = [float(exe.run(tm, feed=f, fetch_list=[lr],
                         scope=scope)[0].reshape(-1)[0]) for f in _feeds()]
    _close(got, want, "run vs JAX")
    assert int(scope.get(COUNTER)[0]) == jcount == 2 * STEPS - 1


def _lars(fl, base_lr):
    main, startup = fl.Program(), fl.Program()
    startup.random_seed = 8
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[4], dtype="float32")
        h = fl.layers.fc(input=x, size=3, act="tanh",
                         param_attr=fl.ParamAttr(name="h.w",
                                                 learning_rate=0.5))
        loss = fl.layers.reduce_mean(fl.layers.square(
            fl.layers.fc(input=h, size=1, param_attr=fl.ParamAttr(
                name="o.w"))))
        opt = fl.optimizer.Momentum(learning_rate=0.1, momentum=0.9)
        p_g = opt.backward(loss)
        lr = base_lr(fl.layers) if base_lr else 0.1
        fl.layers.append_LARS(p_g, learning_rate=lr, weight_decay=0.01)
        opt.apply_gradients(p_g)
    return main, startup, loss


@pytest.mark.parametrize("base", ["float", "schedule"])
def test_append_lars_with_momentum_matches_jax(base):
    """append_LARS gives each parameter its own rate Variable (times its
    ParamAttr learning_rate where it has one), which the momentum op
    reads; three steps' losses and parameters match the JAX executor's at
    the optimizers' tolerance (test_torch_optimizer_zoo.py: the rate is
    a ratio of norms of parameters that the steps move)."""
    base_lr = None if base == "float" else \
        (lambda L: L.exponential_decay(0.1, 3, 0.5))
    jm, js, jloss = _lars(jfluid, base_lr)
    tm, ts, tloss = _lars(tfluid, base_lr)
    assert _signature(tm) == _signature(jm)
    lrs = {tuple(op.input("LearningRate")) for op in tm.global_block().ops
           if op.type == "momentum"}
    assert len(lrs) == 4
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    jexe.run(js, scope=jscope)
    texe.run(ts, scope=tscope)
    names = [v.name for v in jm.global_block().vars.values()
             if v.persistable and jscope.get(v.name) is not None]
    tfluid.params_from_numpy({n: np.asarray(jscope.get(n)) for n in names},
                             tscope, "cpu")
    for f in _feeds()[:3]:
        want, = jexe.run(jm, feed=f, fetch_list=[jloss], scope=jscope)
        got, = texe.run(tm, feed=f, fetch_list=[tloss], scope=tscope)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    for n in names:
        np.testing.assert_allclose(
            texecutor.as_numpy(tscope.get(n)).astype(np.float64),
            np.asarray(jscope.get(n)).astype(np.float64), rtol=1e-5,
            atol=1e-7, err_msg=n)
