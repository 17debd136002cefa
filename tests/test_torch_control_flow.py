"""While, Switch, IfElse and their gradients on the port against the JAX
package, on the CPU.

Every program of tests/test_control_flow_grad.py, and the While and Switch
programs of tests/test_sequence_rnn.py, is built by both packages from the
same code (``fluid`` is either package) and must be op for op the JAX
package's in every block (types, slots, attrs, variables, each block's
parent). Both executors then run it from the JAX package's startup state
(carried over by ``params_from_numpy``) on the same seeded numpy feeds, and
every fetched value must agree within 1e-5 of its largest JAX magnitude
plus 1e-7 absolute (float32; the values are a few scales, products and
means). The training programs run their steps in lockstep, loss by loss
and parameter by parameter, under the same bound. The closed forms the
original tests check hold on the port's values too.

Where the two packages draw random numbers the values differ (a JAX key
against a torch generator), so the stochastic bodies are held to
invariants: the grad replay of a While draws what the forward drew, and
every trip of a While draws one mask (the JAX package traces the body
once). The errors of append_backward are the JAX package's, message for
message.
"""
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid

TOL = 1e-5
ATOL = 1e-7


def signature(program):
    """Every block of a program as comparable data: its parent, each op's
    type, slots and attrs, and each variable's name, shape, dtype and
    flags."""
    out = []
    for b in program.blocks:
        ops = [(op.type, dict(op.inputs), dict(op.outputs),
                sorted((k, repr(v)) for k, v in op.attrs.items()))
               for op in b.ops]
        vars_ = [(v.name, v.shape, v.dtype, v.persistable, v.stop_gradient,
                  type(v).__name__) for v in b.vars.values()]
        out.append((b.idx, b.parent_idx, ops, vars_))
    return out


def programs(fluid, build, seed=5):
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        fetch = build(fluid)
    return main, startup, fetch


def _names(fetch):
    return [v if isinstance(v, str) else v.name for v in fetch]


def _state(scope, program):
    return {v.name: np.asarray(scope.get(v.name))
            for v in program.global_block().vars.values()
            if v.persistable and scope.get(v.name) is not None}


def assert_close(got, want, what=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not want.size:
        return
    if np.isnan(want).any():
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), what)
        ok = ~np.isnan(want)
        got, want = got[ok], want[ok]
        if not want.size:
            return
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= TOL * scale + ATOL, what


class Both(object):
    """A program built by both packages (op for op equal) and both
    executors on the CPU, the port's scope holding the JAX startup's
    state."""

    def __init__(self, build, seed=5):
        self.j = programs(jfluid, build, seed)
        self.t = programs(tfluid, build, seed)
        assert signature(self.j[0]) == signature(self.t[0])
        assert signature(self.j[1]) == signature(self.t[1])
        self.jexe = jfluid.Executor(jfluid.CPUPlace())
        self.texe = tfluid.Executor(tfluid.CPUPlace())
        self.jscope, self.tscope = jfluid.Scope(), tfluid.Scope()
        self.jexe.run(self.j[1], scope=self.jscope)
        self.texe.run(self.t[1], scope=self.tscope)
        tfluid.params_from_numpy(_state(self.jscope, self.j[0]),
                                 self.tscope, "cpu")

    @property
    def fetch(self):
        return _names(self.t[2])

    def run(self, feed, fetch=None):
        """One run of each; every fetched value within the bound. Returns
        the port's values."""
        names = fetch or self.fetch
        want = self.jexe.run(self.j[0], feed=feed, fetch_list=names,
                             scope=self.jscope)
        got = self.texe.run(self.t[0], feed=feed, fetch_list=names,
                            scope=self.tscope)
        for n, g, w in zip(names, got, want):
            assert_close(g, w, n)
        for n, w in _state(self.jscope, self.j[0]).items():
            assert_close(self.tscope.get(n).numpy(), w, n)
        return [np.asarray(g) for g in got]


def both_raise(build, match):
    """Building the program raises NotImplementedError in both packages,
    with the same message."""
    msgs = []
    for fluid in (jfluid, tfluid):
        with pytest.raises(NotImplementedError, match=match) as e:
            programs(fluid, build)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# --------------------------------------------------------------------------
# the programs of tests/test_control_flow_grad.py, on either package
# --------------------------------------------------------------------------

def _counter(L, limit, start=0.0):
    i = L.fill_constant([1], "float32", start)
    lim = L.fill_constant([1], "float32", limit)
    return i, lim, L.less_than(i, lim)


def _step(L, i, lim, cond):
    L.increment(i, value=1.0, in_place=True)
    L.less_than(i, lim, cond=cond)


def inferred_bound(fluid):
    """s = x; 3x (s *= 2) => s = 8x."""
    L = fluid.layers
    x = L.data(name="x", shape=[4], dtype="float32")
    x.stop_gradient = False
    s = L.scale(x, scale=1.0)
    i, lim, cond = _counter(L, 3.0)
    with L.While(cond).block():
        L.assign(L.scale(s, scale=2.0), output=s)
        _step(L, i, lim, cond)
    loss = L.reduce_mean(s)
    (dx,) = fluid.backward.gradients(loss, [x])
    return [loss, dx, cond, i]


def _param(fluid, shape, init):
    return fluid.layers.create_parameter(
        shape=shape, dtype="float32", default_initializer=init)


def param_accumulates(fluid):
    """s_final = x * w^3 elementwise."""
    L = fluid.layers
    x = L.data(name="x", shape=[4], dtype="float32")
    w = _param(fluid, [4], fluid.initializer.NumpyArrayInitializer(
        np.array([0.9, 1.1, 1.3, 0.7], dtype="float32")))
    s = L.scale(x, scale=1.0)
    i, lim, cond = _counter(L, 3.0)
    with L.While(cond).block():
        L.assign(L.elementwise_mul(s, w, axis=1), output=s)
        _step(L, i, lim, cond)
    loss = L.reduce_mean(s)
    p_g = fluid.backward.append_backward(loss)
    return [loss, dict((p.name, g) for p, g in p_g)[w.name]]


def _fed_limit_loop(fluid, max_trip_count):
    L = fluid.layers
    x = L.data(name="x", shape=[2], dtype="float32")
    x.stop_gradient = False
    limit = L.data(name="limit", shape=[1], dtype="float32",
                   append_batch_size=False)
    s = L.scale(x, scale=1.0)
    i = L.fill_constant([1], "float32", 0.0)
    cond = L.less_than(i, limit)
    with L.While(cond, max_trip_count=max_trip_count).block():
        L.assign(L.scale(s, scale=0.5), output=s)
        _step(L, i, limit, cond)
    loss = L.reduce_sum(s)
    (dx,) = fluid.backward.gradients(loss, [x])
    return [loss, dx]


def explicit_bound(fluid):
    return _fed_limit_loop(fluid, 8)


def bound_too_small(fluid):
    return _fed_limit_loop(fluid, 2)


def unbounded(fluid):
    return _fed_limit_loop(fluid, None)


def training_loop(fluid):
    """s = x * w^4 driven toward x by SGD."""
    L = fluid.layers
    x = L.data(name="x", shape=[3], dtype="float32")
    w = _param(fluid, [3], fluid.initializer.ConstantInitializer(1.5))
    s = L.scale(x, scale=1.0)
    i, lim, cond = _counter(L, 4.0)
    with L.While(cond).block():
        L.assign(L.elementwise_mul(s, w, axis=1), output=s)
        _step(L, i, lim, cond)
    loss = L.reduce_mean(L.square(L.elementwise_sub(s, x)))
    fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return [loss, w]


def _switch_out(fluid, a_val, b_val, out_val, shape):
    L = fluid.layers
    x = L.data(name="x", shape=shape[1:], dtype="float32")
    x.stop_gradient = False
    a = L.fill_constant([1], "float32", a_val)
    b = L.fill_constant([1], "float32", b_val)
    out = L.fill_constant(shape, "float32", out_val)
    out.stop_gradient = False
    return x, L.less_than(a, b), out


def taken_branch(fluid):
    """cond true: out = 2x."""
    L = fluid.layers
    x, cond, out = _switch_out(fluid, 1.0, 2.0, 0.0, [2, 3])
    sw = L.Switch()
    with sw:
        with sw.case(cond):
            L.assign(L.scale(x, scale=2.0), output=out)
    loss = L.reduce_mean(out)
    return [loss] + fluid.backward.gradients(loss, [x])


def untaken_branch(fluid):
    """cond false: out keeps its value, x gets a zero gradient."""
    L = fluid.layers
    x, cond, out = _switch_out(fluid, 3.0, 2.0, 5.0, [2, 3])
    sw = L.Switch()
    with sw:
        with sw.case(cond):
            L.assign(L.scale(x, scale=2.0), output=out)
    loss = L.reduce_mean(out)
    return [loss] + fluid.backward.gradients(loss, [x])


def nonlinear_branch(fluid):
    """A taken branch writing tanh(x^2)."""
    L = fluid.layers
    x, cond, out = _switch_out(fluid, 0.0, 1.0, 0.0, [2, 2])
    sw = L.Switch()
    with sw:
        with sw.case(cond):
            L.assign(L.tanh(L.square(x)), output=out)
    loss = L.reduce_sum(out)
    return [loss] + fluid.backward.gradients(loss, [x])


def ifelse_branchy(fluid, width=1):
    """Two-branch regressor: each branch scales x by its own parameter."""
    L = fluid.layers
    x = L.data(name="x", shape=[width], dtype="float32")
    y = L.data(name="y", shape=[width], dtype="float32")
    limit = L.fill_constant([1], "float32", 0.5)
    cond = L.less_than(x, limit)
    init = fluid.initializer.ConstantInitializer(1.0)
    wa, wb = _param(fluid, [width], init), _param(fluid, [width], init)
    ie = L.IfElse(cond)
    with ie.true_block():
        ie.output(L.elementwise_mul(ie.input(x), wa, axis=1))
    with ie.false_block():
        ie.output(L.elementwise_mul(ie.input(x), wb, axis=1))
    pred = ie()[0]
    loss = L.reduce_mean(L.square(L.elementwise_sub(pred, y)))
    fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return [loss, wa, wb]


def append_lars(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[4], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="float32")
    pred = L.fc(input=x, size=1)
    loss = L.reduce_mean(L.square(L.elementwise_sub(pred, y)))
    opt = fluid.optimizer.SGD(learning_rate=0.1)
    p_g = opt.backward(loss)
    L.append_LARS(p_g, learning_rate=0.1, weight_decay=0.01)
    opt.apply_gradients(p_g)
    return [loss]


def two_whiles(fluid):
    """Two loops over one variable: s = 2^2 * 3^2 x."""
    L = fluid.layers
    x = L.data(name="x", shape=[3], dtype="float32")
    x.stop_gradient = False
    s = L.scale(x, scale=1.0)
    for k in (2.0, 3.0):
        i, lim, cond = _counter(L, 2.0)
        with L.While(cond).block():
            L.assign(L.scale(s, scale=k), output=s)
            _step(L, i, lim, cond)
    loss = L.reduce_sum(s)
    return [loss] + fluid.backward.gradients(loss, [x])


def switch_default(a_val):
    """Switch: the case writes out = 3w, the default out = 5w."""
    def build(fluid):
        L = fluid.layers
        wp = _param(fluid, [4], fluid.initializer.ConstantInitializer(1.0))
        a = L.fill_constant([1], "float32", a_val)
        b = L.fill_constant([1], "float32", 2.0)
        out = L.fill_constant([4], "float32", 0.0)
        out.stop_gradient = False
        cond = L.less_than(a, b)
        sw = L.Switch()
        with sw:
            with sw.case(cond):
                L.assign(L.scale(wp, scale=3.0), output=out)
            with sw.default():
                L.assign(L.scale(wp, scale=5.0), output=out)
        loss = L.reduce_sum(out)
        p_g = fluid.backward.append_backward(loss)
        return [out, dict((p.name, g) for p, g in p_g)[wp.name]]
    return build


def stochastic_body(fluid):
    """s += u * w with u drawn in the body."""
    L = fluid.layers
    x = L.data(name="x", shape=[3], dtype="float32",
               append_batch_size=False)
    w = _param(fluid, [3], fluid.initializer.NumpyArrayInitializer(
        np.array([0.5, 1.5, -0.7], dtype="float32")))
    s = L.scale(x, scale=1.0)
    i, lim, cond = _counter(L, 3.0)
    with L.While(cond).block():
        u = L.uniform_random([3], min=0.5, max=1.5)
        L.assign(L.elementwise_add(s, L.elementwise_mul(u, w)), output=s)
        _step(L, i, lim, cond)
    loss = L.reduce_sum(s)
    p_g = fluid.backward.append_backward(loss)
    return [loss, dict((p.name, g) for p, g in p_g)[w.name]]


def dropout_body(fluid):
    """acc += dropout(ones) on each of 3 trips."""
    L = fluid.layers
    ones = L.fill_constant([16, 32], "float32", 1.0)
    acc = L.fill_constant([16, 32], "float32", 0.0)
    i, lim, cond = _counter(L, 3.0)
    with L.While(cond).block():
        L.assign(L.elementwise_add(acc, L.dropout(ones, 0.5)), output=acc)
        _step(L, i, lim, cond)
    return [acc]


def _nested(fluid, inner_bound):
    """s *= 2 in an inner loop of 2 trips in an outer loop of 2."""
    L = fluid.layers
    x = L.data(name="x", shape=[2], dtype="float32",
               append_batch_size=False)
    x.stop_gradient = False
    s = L.scale(x, scale=1.0)
    io, lo, co = _counter(L, 2.0)
    with L.While(co).block():
        ii, li, ci = _counter(L, 2.0)
        with L.While(ci, max_trip_count=inner_bound).block():
            L.assign(L.scale(s, scale=2.0), output=s)
            _step(L, ii, li, ci)
        _step(L, io, lo, co)
    loss = L.reduce_sum(s)
    return [loss] + fluid.backward.gradients(loss, [x])


def nested_bounded(fluid):
    return _nested(fluid, 2)


def nested_unbounded(fluid):
    return _nested(fluid, None)


def while_sums(fluid):
    """tests/test_sequence_rnn.py's loop: acc = 1 + 2 + 3 + 4."""
    L = fluid.layers
    i, limit, cond = _counter(L, 4.0)
    acc = L.fill_constant([1], "float32", 0.0)
    with L.While(cond).block():
        L.increment(i, 1.0)
        L.sums([acc, i], out=acc)
        L.less_than(i, limit, cond=cond)
    return [acc]


def switch_fill(fluid):
    """tests/test_sequence_rnn.py's Switch: out = 1 when 7 > 5."""
    L = fluid.layers
    x = L.fill_constant([1], "float32", 7.0)
    thresh = L.fill_constant([1], "float32", 5.0)
    out = L.fill_constant([1], "float32", 0.0)
    cond = L.greater_than(x, thresh)
    sw = L.Switch()
    with sw:
        with sw.case(cond):
            L.assign(L.fill_constant([1], "float32", 1.0), out)
    return [out]


# --------------------------------------------------------------------------
# the cases
# --------------------------------------------------------------------------

def _x(shape, seed, offset=0.0):
    return np.random.RandomState(seed).rand(*shape).astype("float32") + \
        offset


def test_while_grad_inferred_bound_numeric():
    xnp = _x((2, 4), 0)
    loss, dx, cond, i = Both(inferred_bound).run({"x": xnp})
    np.testing.assert_allclose(loss, 8.0 * xnp.mean(), rtol=1e-5)
    np.testing.assert_allclose(dx, np.full_like(xnp, 8.0 / xnp.size),
                               rtol=1e-5)
    assert cond.shape == (1,) and not cond.any() and i.item() == 3.0


def test_while_grad_param_accumulates_across_iters():
    xnp = _x((3, 4), 1, 0.5)
    wnp = np.array([0.9, 1.1, 1.3, 0.7], dtype="float32")
    loss, dw = Both(param_accumulates).run({"x": xnp})
    np.testing.assert_allclose(loss, (xnp * wnp ** 3).mean(), rtol=1e-5)
    np.testing.assert_allclose(dw, 3.0 * wnp ** 2 * xnp.sum(0) / xnp.size,
                               rtol=1e-4)


def test_while_grad_explicit_max_trip_count():
    xnp = np.array([[1.0, 2.0]], dtype="float32")
    loss, dx = Both(explicit_bound).run(
        {"x": xnp, "limit": np.array([2.0], dtype="float32")})
    np.testing.assert_allclose(loss, xnp.sum() / 4.0, rtol=1e-5)
    np.testing.assert_allclose(dx, np.full_like(xnp, 0.25), rtol=1e-5)


def test_while_grad_unbounded_raises_as_in_jax():
    both_raise(unbounded, "max_trip_count")


def test_while_grad_bound_too_small_poisons_nan():
    loss, dx = Both(bound_too_small).run(
        {"x": np.array([[1.0, 2.0]], dtype="float32"),
         "limit": np.array([4.0], dtype="float32")})
    assert np.isnan(dx).all() and np.isfinite(loss)


def test_while_training_in_lockstep():
    both = Both(training_loop)
    xnp = _x((4, 3), 2, 0.5)
    losses = [float(both.run({"x": xnp})[0]) for _ in range(12)]
    assert losses[-1] < losses[0] * 0.5


def test_conditional_block_grad_taken_branch():
    xnp = np.arange(6, dtype="float32").reshape(2, 3) + 1.0
    loss, dx = Both(taken_branch).run({"x": xnp})
    np.testing.assert_allclose(loss, 2.0 * xnp.mean(), rtol=1e-5)
    np.testing.assert_allclose(dx, np.full_like(xnp, 2.0 / xnp.size),
                               rtol=1e-5)


def test_conditional_block_grad_untaken_branch_zero():
    loss, dx = Both(untaken_branch).run({"x": np.ones((2, 3), "float32")})
    np.testing.assert_allclose(loss, 5.0, rtol=1e-5)
    assert not dx.any()


def test_conditional_block_finite_difference():
    """The port's gradient through a taken branch against central
    differences of the port's own loss (float64 differences of float32
    losses: eps 1e-3, rtol 2e-2)."""
    both = Both(nonlinear_branch)
    xnp = _x((2, 2), 3, 0.5)
    _, dx = both.run({"x": xnp})
    eps = 1e-3
    for idx in [(0, 0), (1, 1)]:
        xp, xm = xnp.copy(), xnp.copy()
        xp[idx] += eps
        xm[idx] -= eps
        num = (float(both.run({"x": xp})[0]) -
               float(both.run({"x": xm})[0])) / (2 * eps)
        np.testing.assert_allclose(dx[idx], num, rtol=2e-2, atol=1e-3)


def test_ifelse_trains_branchy_model_in_lockstep():
    both = Both(ifelse_branchy)
    xnp = _x((16, 1), 7)
    ynp = np.where(xnp < 0.5, 3.0 * xnp, -2.0 * xnp).astype("float32")
    losses = []
    for _ in range(60):
        loss, wa, wb = both.run({"x": xnp, "y": ynp})
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.1
    assert abs(wa.item() - 3.0) < 0.5 and abs(wb.item() + 2.0) < 0.5


def test_append_lars_per_param_lr_in_lockstep():
    both = Both(append_lars)
    rng = np.random.RandomState(8)
    xnp = rng.rand(8, 4).astype("float32")
    ynp = (xnp @ np.array([[1.0], [2.0], [-1.0], [0.5]])).astype("float32")
    losses = [float(both.run({"x": xnp, "y": ynp})[0]) for _ in range(25)]
    assert losses[-1] < losses[0]


def test_two_sequential_whiles_rmw_same_var():
    xnp = np.ones((2, 3), dtype="float32")
    loss, dx = Both(two_whiles).run({"x": xnp})
    np.testing.assert_allclose(loss, 36.0 * xnp.sum(), rtol=1e-5)
    np.testing.assert_allclose(dx, np.full_like(xnp, 36.0), rtol=1e-5)


@pytest.mark.parametrize("a_val,want", [(1.0, 3.0), (3.0, 5.0)])
def test_switch_case_default_exclusive_grads(a_val, want):
    out, dw = Both(switch_default(a_val)).run({})
    np.testing.assert_allclose(out, np.full(4, want), rtol=1e-6)
    np.testing.assert_allclose(dw, np.full(4, want), rtol=1e-5)


def test_while_grad_stochastic_body_replay_consistent():
    """Values differ between the packages' generators; in each, loss -
    sum(x) == dot(dw, w) holds only if the replay's u is the forward's."""
    both = Both(stochastic_body)
    xnp = np.ones((3,), dtype="float32")
    wnp = np.array([0.5, 1.5, -0.7], dtype="float32")
    for exe, (main, _, fetch), scope in (
            (both.jexe, both.j, both.jscope), (both.texe, both.t,
                                               both.tscope)):
        loss, dw = [np.asarray(v) for v in exe.run(
            main, feed={"x": xnp}, fetch_list=_names(fetch), scope=scope)]
        np.testing.assert_allclose(loss - xnp.sum(), np.dot(dw, wnp),
                                   rtol=1e-4)
        assert np.all(dw >= 3 * 0.5) and np.all(dw <= 3 * 1.5)


def test_every_while_trip_draws_one_mask():
    """The JAX package traces a While body once, so a dropout there keeps
    one mask on every trip: after 3 trips each element of acc is 0 or 3x
    the kept value, never 1 or 2 trips' worth; the port sets its generator
    back at each trip to draw the same."""
    both = Both(dropout_body)
    for exe, (main, _, fetch), scope in (
            (both.jexe, both.j, both.jscope), (both.texe, both.t,
                                               both.tscope)):
        acc, = [np.asarray(v) for v in exe.run(
            main, fetch_list=_names(fetch), scope=scope)]
        kept = acc != 0
        assert 0.3 < kept.mean() < 0.7
        np.testing.assert_array_equal(np.unique(acc), [0.0, 3.0])


def test_nested_while_grad_bounded_inner():
    xnp = np.ones((2,), dtype="float32")
    loss, dx = Both(nested_bounded).run({"x": xnp})
    np.testing.assert_allclose(loss, 16.0 * xnp.sum(), rtol=1e-5)
    np.testing.assert_allclose(dx, np.full_like(xnp, 16.0), rtol=1e-5)


def test_nested_while_grad_unbounded_inner_raises_as_in_jax():
    both_raise(nested_unbounded, "NESTED")


def test_while_loop_sums():
    acc, = Both(while_sums).run({})
    assert float(acc.reshape(())) == 10.0


def test_switch_conditional_block():
    out, = Both(switch_fill).run({})
    assert float(out.reshape(())) == 1.0


def _blocks_program(fluid):
    """A While (with a Switch in its body) and a StaticRNN, with
    gradients."""
    L = fluid.layers
    x = L.data(name="x", shape=[3, 4], dtype="float32")
    x.stop_gradient = False
    s = L.reduce_mean(x, dim=1)
    i, lim, cond = _counter(L, 2.0)
    with L.While(cond).block():
        sw = L.Switch()
        with sw:
            with sw.case(L.less_than(i, lim)):
                L.assign(L.scale(s, scale=2.0), output=s)
        _step(L, i, lim, cond)
    rnn = L.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        h = rnn.memory(init=s)
        nh = L.fc(input=[xt, h], size=4, act="tanh")
        rnn.update_memory(h, nh)
        rnn.output(nh)
    out = rnn()
    loss = L.mean(out)
    fluid.backward.append_backward(loss)
    return [out]


def test_sub_blocks_survive_clone_prune_and_serialization():
    """clone, clone(for_test=True), _prune, the JSON form and the
    framework.proto bytes keep every block, in each package as in the
    JAX package (the proto bytes too)."""
    progs = {fl: programs(fl, _blocks_program) for fl in (jfluid, tfluid)}
    forms = {}
    for fl, (main, _, fetch) in progs.items():
        assert main.num_blocks == 4
        forms[fl] = {
            "clone": main.clone(),
            "for_test": main.clone(for_test=True),
            "prune": main._prune(["x"], _names(fetch)),
            "json": fl.Program.parse_from_string(main.serialize_to_json()),
            "proto": fl.Program.parse_from_string(
                main.serialize_to_string())}
    assert progs[jfluid][0].serialize_to_string() == \
        progs[tfluid][0].serialize_to_string()
    for k, t in forms[tfluid].items():
        assert signature(t) == signature(forms[jfluid][k]), k
        assert t.num_blocks == 4, k
    assert signature(forms[tfluid]["clone"]) == signature(progs[tfluid][0])
    ops = [op.type for op in forms[tfluid]["prune"].global_block().ops]
    assert "while" in ops and "recurrent" in ops and "grad_of" not in ops


def _print_program(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[3], dtype="float32")
    return [L.scale(L.Print(L.scale(x, scale=2.0), message="twice"),
                    scale=0.5)]


def test_print_prints_the_value_and_passes_it_on(capsys):
    """The print host op prints what the JAX executor prints, and its Out
    carries the value on."""
    xnp = np.arange(6, dtype="float32").reshape(2, 3)
    printed = []
    for fluid in (jfluid, tfluid):
        main, _, fetch = programs(fluid, _print_program)
        capsys.readouterr()
        out, = fluid.Executor(fluid.CPUPlace()).run(
            main, feed={"x": xnp}, fetch_list=_names(fetch),
            scope=fluid.Scope())
        printed.append(capsys.readouterr().out)
        np.testing.assert_array_equal(np.asarray(out), xnp)
    assert printed[0] == printed[1]
    assert printed[1].startswith("twice ")


def test_go_runs_its_block_and_go_join_returns_its_scope():
    """layers.Go records a sub-block that one go op runs on a thread over
    a child scope, as in the JAX package; go_join returns that scope."""
    xv = np.arange(6, dtype="float32").reshape(2, 3)
    for fluid in (jfluid, tfluid):
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            x = fluid.layers.data(name="x", shape=[3], dtype="float32")
            with fluid.layers.Go().block():
                y = fluid.layers.scale(x, scale=2.0)
        assert [op.type for op in main.global_block().ops] == ["go"]
        assert main.global_block().ops[0].input("X") == ["x"]
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(main, feed={"x": xv}, scope=fluid.Scope())
        child, = exe.go_join(30)
        np.testing.assert_array_equal(np.asarray(
            fluid.executor.as_numpy(child.get(y.name))), 2 * xv)


def _untaken_new_output(fluid):
    """An untaken Switch case writing a variable that holds no value yet:
    it comes out as zeros of the case's shape."""
    L = fluid.layers
    x = L.data(name="x", shape=[3], dtype="float32")
    out = L.create_tensor("float32")
    cond = L.less_than(L.fill_constant([1], "float32", 3.0),
                       L.fill_constant([1], "float32", 2.0))
    sw = L.Switch()
    with sw:
        with sw.case(cond):
            L.assign(L.scale(x, scale=2.0), output=out)
    return [out]


def test_untaken_case_gives_zeros_for_a_new_output():
    out, = Both(_untaken_new_output).run({"x": np.ones((2, 3), "float32")})
    np.testing.assert_array_equal(out, np.zeros((2, 3), "float32"))
