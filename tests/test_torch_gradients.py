"""Input gradients on the port (``fluid.gradients`` / ``calc_gradient``) and
several backward passes over one forward, against the JAX package on the
CPU.

Each program is built by both packages from the same code and must be op
for op the JAX package's (types, inputs, outputs, attrs and variables). Both
executors then run it from the JAX package's startup state (carried over by
``params_from_numpy``) on seeded numpy feeds, and every fetched value must
agree within 1e-5 of its largest JAX magnitude plus 1e-7 absolute
(float32; summation order only: the values are single matmuls, tanh and
reductions of a few elements; the absolute term covers gradients whose
true value is 0, such as the mean of a batch norm's output with respect to
its input, where the JAX executor returns rounding noise of 1e-8).

The executor pairs a forward op with every grad op that walks through it,
one for each append_backward or calc_gradient call: the op is taped once
with the union of its grad ops' leaves, each grad op takes the gradient of
its own leaves, and the graph is kept until the last of them.
"""
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.fluid.ops import registry

import torch_resnet_step as step

TOL = 1e-5
ATOL = 1e-7


def _programs(fluid, build):
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = build(fluid)
    return main, startup, out


def _data(L, name, shape, grad=True):
    return L.data(name=name, shape=shape, dtype="float32",
                  stop_gradient=not grad)


def _feed(names, shapes, seed=0, batch=3):
    rng = np.random.RandomState(seed)
    return {n: rng.uniform(-1.0, 1.0, [batch] + s).astype("float32")
            for n, s in zip(names, shapes)}


def _run_both(build, feed, fetch=None, zero=()):
    """Both packages' programs (op for op equal), each run once from the
    JAX startup state. ``fetch(out)`` names what to fetch (default: every
    @GRAD variable of the program). A name in ``zero`` (a gradient that is
    0 in exact arithmetic) is held instead to 1e-5 of the largest value
    fetched, in both packages. Returns (JAX values, port values, the port's
    main program and build result)."""
    jm, js, jout = _programs(jfluid, build)
    tm, ts, tout = _programs(tfluid, build)
    assert step.signature(jm) == step.signature(tm)
    assert step.signature(js) == step.signature(ts)
    names = fetch(tout) if fetch else sorted(
        n for n in tm.global_block().vars if "@GRAD" in n)
    jexe, texe = jfluid.Executor(jfluid.CPUPlace()), \
        tfluid.Executor(tfluid.CPUPlace())
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe.run(js, scope=jscope)
    texe.run(ts, scope=tscope)
    state = {v.name: np.asarray(jscope.get(v.name))
             for v in jm.global_block().vars.values()
             if v.persistable and jscope.get(v.name) is not None}
    tfluid.params_from_numpy(state, tscope, "cpu")
    want = jexe.run(jm, feed=feed, fetch_list=names, scope=jscope)
    got = texe.run(tm, feed=feed, fetch_list=names, scope=tscope)
    largest = max(np.abs(step.f64(w)).max() for w in want)
    for n, w, g in zip(names, want, got):
        w = step.f64(w)
        assert np.isfinite(g).all(), n
        if n in zero:
            assert max(np.abs(w).max(), np.abs(step.f64(g)).max()) <= \
                TOL * largest, n
            continue
        assert np.abs(step.f64(g) - w).max() <= \
            TOL * (np.abs(w).max() or 1) + ATOL, n
    return dict(zip(names, want)), dict(zip(names, got)), tm, tout


# --------------------------------------------------------------------------
# calc_gradient and gradients
# --------------------------------------------------------------------------

def test_gradients_are_exported():
    assert tfluid.gradients is tfluid.backward.gradients
    assert tfluid.calc_gradient is tfluid.backward.calc_gradient
    assert {"calc_gradient", "gradients"} <= set(tfluid.__all__)
    assert {"calc_gradient", "gradients"} <= set(tfluid.backward.__all__)


def _two_towers(fluid):
    """x and y through their own fc, joined; z reaches no target."""
    L = fluid.layers
    x, y, z = (_data(L, n, [4]) for n in "xyz")
    hx = L.fc(x, 3, act="tanh")
    hy = L.fc(y, 3, act="sigmoid")
    L.fc(z, 2)
    return x, y, z, hx, hy, L.mean(L.elementwise_mul(hx, hy)), \
        L.reduce_sum(L.square(hx))


def test_lists_of_targets_and_inputs_with_an_unreachable_input():
    """Two targets, three inputs: z reaches neither target and gets None;
    each target starts from a fill_constant of ones whose role is
    Backward (not Backward | Loss)."""
    def build(fluid):
        x, y, z, _, _, t1, t2 = _two_towers(fluid)
        return fluid.gradients([t1, t2], [x, y, z])

    want, got, tm, grads = _run_both(
        build, _feed("xyz", [[4]] * 3),
        lambda g: [v.name for v in g if v is not None])
    assert grads[2] is None and [g.name for g in grads[:2]] == \
        ["x@GRAD", "y@GRAD"]
    fills = [op for op in tm.global_block().ops
             if op.type == "fill_constant"]
    assert len(fills) == 2 and all(
        op.attrs[tfluid.OpRole.KEY] == tfluid.OpRole.Backward
        for op in fills)


def test_target_gradients_start_the_walk():
    """A single target and input (not lists) and a target gradient fed as
    data: no fill_constant is added, and the result is d(t . g)/dx."""
    def build(fluid):
        L = fluid.layers
        x = _data(L, "x", [4])
        t = L.fc(x, 3, act="tanh")
        g = _data(L, "g", [3], grad=False)
        return fluid.calc_gradient(t, x, target_gradients=g)

    feed = _feed("xg", [[4], [3]])
    want, got, tm, grads = _run_both(build, feed, lambda g: [g[0].name])
    assert len(grads) == 1 and grads[0].name == "x@GRAD"
    assert not any(op.type == "fill_constant"
                   for op in tm.global_block().ops)


@pytest.mark.parametrize("as_var", [False, True], ids=["name", "variable"])
def test_no_grad_set_cuts_the_walk(as_var):
    """hy in no_grad_set (as a name or as the Variable): nothing flows to
    y, which gets None; x's gradient is unchanged."""
    def build(fluid):
        x, y, _, _, hy, t1, _ = _two_towers(fluid)
        return fluid.gradients(t1, [x, y],
                               no_grad_set={hy if as_var else hy.name})

    want, got, tm, grads = _run_both(build, _feed("xyz", [[4]] * 3),
                                     lambda g: [g[0].name])
    assert grads[1] is None and grads[0].name == "x@GRAD"
    assert "y@GRAD" not in tm.global_block().vars


def test_sources_prune_the_op_path():
    """gradients(t, [x]) differentiates only the ops that x reaches: y's
    tower gets no grad op, where append_backward over t walks both."""
    def build(fluid):
        x, y, _, _, _, t1, _ = _two_towers(fluid)
        return fluid.gradients(t1, [x])

    _, _, tm, _ = _run_both(build, _feed("xyz", [[4]] * 3))
    ops = tm.global_block().ops
    fwd = [op for op in ops if op.attrs.get(tfluid.OpRole.KEY, 0) == 0]
    grads = [op for op in ops if op.type == "grad_of"]
    assert {op.attrs["fwd_type"] for op in grads} == {
        "mul", "elementwise_add", "tanh", "elementwise_mul", "mean"}
    # x's fc (mul, bias add, tanh), the join and the mean: five grad ops;
    # y's fc and z's fc none
    assert len(grads) == 5 and len(fwd) == 12
    names = {n for op in grads for n in op.output_arg_names}
    assert "y@GRAD" not in names and "fc_1.w_0@GRAD" not in names


def test_gradient_penalty_gives_no_second_order_terms():
    """grad_of has no gradient (as in the JAX package): append_backward
    over a loss built from a calc_gradient output returns [] in both
    packages, and the program runs."""
    def build(fluid):
        L = fluid.layers
        x = _data(L, "x", [4])
        loss = L.mean(L.fc(x, 3, act="tanh"))
        dx, = fluid.gradients(loss, [x])
        penalty = L.reduce_sum(L.square(dx))
        return penalty, fluid.backward.append_backward(penalty)

    want, got, _, (penalty, pg) = _run_both(
        build, _feed("x", [[4]]), lambda out: [out[0].name])
    assert pg == []
    jm, _, (_, jpg) = _programs(jfluid, build)
    assert jpg == []


def test_two_gradients_of_one_input_overwrite_its_grad():
    """gradients(loss, [x]) then gradients(h, [x], target_gradients=[g])
    both write x@GRAD: sign reads the first before the second is appended,
    and a fetch of x@GRAD returns the second, in both packages."""
    def build(fluid):
        L = fluid.layers
        x = _data(L, "x", [4])
        h = L.fc(x, 3, act="tanh")
        loss = L.mean(L.square(h))
        d1, = fluid.gradients(loss, [x])
        s = L.sign(d1)
        g = _data(L, "g", [3], grad=False)
        d2, = fluid.gradients(h, [x], target_gradients=[g])
        return d1, s, d2

    want, got, tm, (d1, s, d2) = _run_both(
        build, _feed("xg", [[4], [3]]), lambda out: [out[1].name, "x@GRAD"])
    assert d1.name == d2.name == "x@GRAD"
    # the fetched x@GRAD is the second gradient: its sign differs from the
    # first's somewhere
    assert not np.array_equal(np.sign(got["x@GRAD"]), got[s.name])
    writers = [op for op in tm.global_block().ops
               if "x@GRAD" in op.output_arg_names]
    assert len(writers) == 2


# --------------------------------------------------------------------------
# several backward passes over one forward
# --------------------------------------------------------------------------

def _fc_twice(fluid, bn=False):
    """Two append_backward calls over one fc (and batch_norm)."""
    L = fluid.layers
    x = L.data(name="x", shape=[4], dtype="float32")
    h = L.fc(x, 3, act="tanh")
    if bn:
        h = L.batch_norm(h)
    fluid.backward.append_backward(L.mean(h))
    fluid.backward.append_backward(L.mean(L.square(h)))


def _tanh_twice(fluid):
    """tanh(x) computed twice: each copy has its own grad op, then a second
    pass walks the first copy again."""
    L = fluid.layers
    x = _data(L, "x", [4])
    a, b = L.tanh(x), L.tanh(x)
    fluid.backward.append_backward(L.mean(L.elementwise_mul(a, b)))
    fluid.backward.append_backward(L.mean(L.square(a)))
    return a, b


@pytest.mark.parametrize("build,grad_type,twice", [
    (_fc_twice, "grad_of", 3),
    (lambda fl: _fc_twice(fl, bn=True), "batch_norm_grad", 1),
    (_tanh_twice, "grad_of", 1)], ids=["fc", "batch_norm", "twin_tanh"])
def test_several_backward_passes_over_one_forward(build, grad_type, twice):
    """The repro: the programs have 9, 9 and 7 grad ops in both packages
    and the port's executor runs them to the JAX executor's values (every
    @GRAD variable). Forward ops with two grad ops (``twice`` of the
    paired kind) are taped once, with their last grad op freeing the
    record. The batch norm's case takes 16 rows: its statistics over 2
    rows round otherwise in the two packages (ROADMAP Queue 3: XLA fuses
    the sum of squares into FMAs) and its backward amplifies that to 3e-4
    of the fc's gradient."""
    feed = {"x": np.linspace(-1, 1, 8).reshape(2, 4).astype("float32")}
    if grad_type == "batch_norm_grad":
        feed = _feed("x", [[4]], batch=16)
    _, _, tm, _ = _run_both(build, feed)
    plan = texecutor._Plan(tm, [n for n in tm.global_block().vars
                                if "@GRAD" in n])
    counts = {}
    for k, f in plan.grad_fwd.items():
        counts[f] = counts.get(f, 0) + 1
    steps = [op for op, _ in plan.steps]
    two = [f for f, c in counts.items() if c == 2]
    assert sum(1 for f in two for k, g in plan.grad_fwd.items()
               if g == f and steps[k].type == grad_type) == 2 * twice
    for f in two:
        assert plan.last_grad[f] == max(k for k, g in plan.grad_fwd.items()
                                        if g == f)


def test_twin_ops_keep_their_own_grad_ops():
    """tanh(x) twice: the first pass's two grad_of(tanh) ops pair with the
    two copies, and the second pass's with the first copy."""
    tm, _, (a, b) = _programs(tfluid, _tanh_twice)
    plan = texecutor._Plan(tm, ["x@GRAD", "x@GRAD@RENAME@1"])
    steps = [op for op, _ in plan.steps]
    pairs = [(steps[k], steps[f]) for k, f in sorted(plan.grad_fwd.items())
             if steps[k].attrs["fwd_type"] == "tanh"]
    assert [f.output("Out")[0] for _, f in pairs] == \
        [b.name, a.name, a.name]
    assert all(g.input("OG:Out")[0].startswith(f.output("Out")[0] + "@GRAD")
               for g, f in pairs)


def test_each_forward_op_runs_once_over_two_passes(monkeypatch):
    """Two backward passes over the fc: its mul, bias add and tanh each run
    once a step (taped with both passes' leaves)."""
    tm, ts, _ = _programs(tfluid, _fc_twice)
    calls = {}
    for op_type in ("mul", "tanh"):
        fn = registry.get_lowering(op_type)

        def counted(ctx, inputs, attrs, _fn=fn, _t=op_type):
            calls[_t] = calls.get(_t, 0) + 1
            return _fn(ctx, inputs, attrs)
        monkeypatch.setitem(registry._LOWERINGS, op_type, counted)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(ts, scope=scope)
    exe.run(tm, feed={"x": np.ones((2, 4), "float32")},
            fetch_list=["fc_0.w_0@GRAD"], scope=scope)
    assert calls == {"mul": 1, "tanh": 1}


def test_a_rewritten_name_is_dead_between_its_writes():
    """The plan's liveness: x@GRAD, written by two passes and not fetched,
    is dropped after its first reader (sign) and written again for the
    second (scale); the weight gradients, which no op reads, are not
    computed (the grad_of's IG:Y slot is dead). The values agree with the
    JAX executor's."""
    def build(fluid):
        L = fluid.layers
        x = _data(L, "x", [4])
        h = L.fc(x, 3, act="tanh", bias_attr=False)
        d1, = fluid.gradients(L.mean(h), [x])
        s1 = L.sign(d1)
        d2, = fluid.gradients(L.reduce_sum(L.square(h)), [x])
        return s1, L.scale(d2, scale=2.0)

    fetch = lambda out: [v.name for v in out]
    _run_both(build, _feed("x", [[4]]), fetch)
    tm, ts, out = _programs(tfluid, build)
    plan = texecutor._Plan(tm, fetch(out))
    steps = [op for op, _ in plan.steps]
    k_sign = [k for k, op in enumerate(steps) if op.type == "sign"][0]
    assert "x@GRAD" in plan.steps[k_sign][1]
    muls = [k for k, op in enumerate(steps) if op.type == "grad_of" and
            op.attrs["fwd_type"] == "mul"]
    assert len(muls) == 2
    assert all("IG:X" in plan.live[k] and "IG:Y" not in plan.live[k]
               for k in muls)
