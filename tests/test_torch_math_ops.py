"""The compare, math, activation, reduction and label_smooth lowerings that
the training surface adds to the port, each against the JAX package's
lowering of the same op on the same inputs, on the CPU; and a few programs
through append_backward against the JAX executor.

Inputs come from seeded numpy and enter both packages as the same values
(bf16 inputs are the f32 draws rounded to nearest even by each).

Tolerances. float32: |got - want| <= 1e-6 * |want| + 1e-6 * max |want|
(the two libraries' transcendental functions differ by a few ulp, and sums
run in other orders; the second term covers elements near zero). bfloat16:
one bf16 ulp, 2^-7 * |want|, in place of the first term, against the JAX
lowering run in float32 on the same bf16 values: the port computes a
bf16 activation in f32 and rounds once, where the JAX lowering in bf16
rounds each operation of its formula. Compare, logical, integer and
rounding ops (floor, ceil, round, sign, max, min, mod and floordiv of
integers) must be equal. Gradients (f32): the JAX lowering's ``jax.vjp``
against the port lowering's autograd at the f32 tolerance; through
append_backward, the JAX executor's gradients against the port's at
1e-5 relative (sums in other orders over a whole program).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid.ops import registry as jreg
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid.ops import registry as treg

BF16_ULP = 2.0 ** -7


def _np(x):
    """A torch or JAX array as float64 (or int64, or bool) numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        x = x.float() if x.dtype == torch.bfloat16 else x
        x = x.numpy()
    else:
        x = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                       else x)
    if x.dtype == np.bool_:
        return x
    return x.astype(np.int64 if x.dtype.kind in "iu" else np.float64)


def _rng(seed):
    return np.random.RandomState(seed)


def _randn(*shape, seed=0, scale=1.0):
    return (_rng(seed).randn(*shape) * scale).astype(np.float32)


def _pos(*shape, seed=0):
    return (np.abs(_rng(seed).randn(*shape)) + 0.1).astype(np.float32)


def _unit(*shape, seed=0):
    return _rng(seed).uniform(-0.95, 0.95, shape).astype(np.float32)


def _away(*shape, seed=0):
    """Values at least 0.5 from zero, of both signs."""
    x = _randn(*shape, seed=seed)
    return (np.sign(x) * (np.abs(x) + 0.5)).astype(np.float32)


def _halves():
    """Draws plus exact halves (round to even in both packages)."""
    extra = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.0, 3.0],
                     np.float32)
    return np.concatenate([_randn(4, 8, scale=3.0).reshape(-1),
                           extra]).reshape(5, 8)


def _bf16(a):
    """An f32 array rounded to bf16 and back (round to nearest even)."""
    return _np(torch.from_numpy(a).to(torch.bfloat16)).astype(np.float32)


def _inputs(arrays, dtype, slots=("X", "Y")):
    """{slot: [numpy]} as JAX and torch inputs; in bf16 the float32 arrays
    of ``slots`` become bf16."""
    def j(a, slot):
        a = jnp.asarray(a)
        return a.astype(jnp.bfloat16) if dtype == "bfloat16" and \
            slot in slots and a.dtype == jnp.float32 else a

    def t(a, slot):
        a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(torch.bfloat16) if dtype == "bfloat16" and \
            slot in slots and a.dtype == torch.float32 else a
    return ({k: [j(a, k) for a in v] for k, v in arrays.items()},
            {k: [t(a, k) for a in v] for k, v in arrays.items()})


def _run(op, arrays, attrs, dtype="float32"):
    jin, tin = _inputs(arrays, dtype)
    want = jreg.get_lowering(op)(jreg.LoweringContext(), jin, attrs)
    got = treg.get_lowering(op)(treg.LoweringContext("cpu"), tin, attrs)
    return want, got


def _close(got, want, dtype="float32", exact=False, err_msg=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    if exact or got.dtype == np.bool_ or got.dtype.kind == "i":
        np.testing.assert_array_equal(got, want, err_msg=err_msg)
        return
    rtol = BF16_ULP if dtype == "bfloat16" else 1e-6
    bound = rtol * np.abs(want) + 1e-6 * np.abs(want).max()
    err = np.abs(got - want)
    assert (err <= bound).all(), (err_msg, err.max(), (err - bound).max())


# --------------------------------------------------------------------------
# the cases: op -> (inputs, attrs, the output slot checked and taken the
# gradient of)
# --------------------------------------------------------------------------

def _cmp_inputs():
    x = np.round(_randn(4, 6, scale=2.0))
    y = np.round(_randn(4, 6, seed=1, scale=2.0))
    return {"X": [x], "Y": [y]}


def _bool(seed):
    return _rng(seed).rand(4, 6) > 0.5


COMPARE = {name: (_cmp_inputs(), {}, "Out") for name in
           ("equal", "not_equal", "less_than", "less_equal", "greater_than",
            "greater_equal")}
COMPARE.update({
    "logical_and": ({"X": [_bool(0)], "Y": [_bool(1)]}, {}, "Out"),
    "logical_or": ({"X": [_bool(0)], "Y": [_bool(1)]}, {}, "Out"),
    "logical_xor": ({"X": [_bool(0)], "Y": [_bool(1)]}, {}, "Out"),
    "logical_not": ({"X": [_bool(0)]}, {}, "Out"),
    "is_empty": ({"X": [_randn(2, 3)]}, {}, "Out"),
})

MATH = {
    "elementwise_max": ({"X": [_randn(4, 6)], "Y": [_randn(4, 6, seed=1)]},
                        {"axis": -1}, "Out"),
    "elementwise_min": ({"X": [_randn(4, 6)], "Y": [_randn(4, 6, seed=1)]},
                        {"axis": -1}, "Out"),
    "elementwise_pow": ({"X": [_pos(4, 6)], "Y": [_randn(4, 6, seed=1)]},
                        {"axis": -1}, "Out"),
    "elementwise_mod": ({"X": [_randn(4, 6, scale=5.0)],
                         "Y": [_away(4, 6, seed=1)]}, {"axis": -1}, "Out"),
    "elementwise_floordiv": ({"X": [_randn(4, 6, scale=5.0)],
                              "Y": [_away(4, 6, seed=1)]}, {"axis": -1},
                             "Out"),
    "squared_l2_distance": ({"X": [_randn(5, 4, 3)],
                             "Y": [_randn(1, 4, 3, seed=1)]}, {}, "Out"),
    "cumsum": ({"X": [_randn(3, 5, 4)]}, {"axis": 1}, "Out"),
    "increment": ({"X": [_randn(3, 4)]}, {"step": 2.5}, "Out"),
    "minus": ({"X": [_randn(3, 4)], "Y": [_randn(3, 4, seed=1)]}, {}, "Out"),
    "cos_sim": ({"X": [_randn(5, 8)], "Y": [_randn(5, 8, seed=1)]}, {},
                "Out"),
    "l1_norm": ({"X": [_randn(4, 6)]}, {}, "Out"),
    "norm": ({"X": [_randn(4, 6)]}, {"axis": 1, "epsilon": 1e-10}, "Out"),
    "isfinite": ({"X": [_randn(3, 4), _randn(5, seed=1)]}, {}, "Out"),
}

_X = lambda: {"X": [_randn(6, 20, scale=2.0)]}
ACTIVATIONS = {
    "abs": (_X(), {}, "Out"),
    "acos": ({"X": [_unit(6, 20)]}, {}, "Out"),
    "asin": ({"X": [_unit(6, 20)]}, {}, "Out"),
    "atan": (_X(), {}, "Out"),
    "ceil": ({"X": [_halves()]}, {}, "Out"),
    "cos": (_X(), {}, "Out"),
    "exp": (_X(), {}, "Out"),
    "floor": ({"X": [_halves()]}, {}, "Out"),
    "log": ({"X": [_pos(6, 20)]}, {}, "Out"),
    "reciprocal": ({"X": [_away(6, 20)]}, {}, "Out"),
    "round": ({"X": [_halves()]}, {}, "Out"),
    "sin": (_X(), {}, "Out"),
    "softsign": (_X(), {}, "Out"),
    "logsigmoid": (_X(), {}, "Out"),
    "brelu": (_X(), {"t_min": -1.0, "t_max": 2.0}, "Out"),
    "elu": (_X(), {"alpha": 0.7}, "Out"),
    "hard_shrink": (_X(), {"threshold": 0.8}, "Out"),
    "hard_sigmoid": (_X(), {"slope": 0.25, "offset": 0.5}, "Out"),
    "leaky_relu": (_X(), {"alpha": 0.1}, "Out"),
    "pow": ({"X": [_pos(6, 20)]}, {"factor": 2.5}, "Out"),
    "relu6": ({"X": [_randn(6, 20, scale=5.0)]}, {"threshold": 6.0}, "Out"),
    "soft_relu": ({"X": [_randn(6, 20, scale=10.0)]}, {"threshold": 8.0},
                  "Out"),
    "softplus": ({"X": [_randn(6, 20, scale=10.0)]}, {}, "Out"),
    "softshrink": (_X(), {"lambda": 0.6}, "Out"),
    "stanh": (_X(), {"scale_a": 0.67, "scale_b": 1.72}, "Out"),
    "swish": (_X(), {"beta": 1.5}, "Out"),
    "tanh_shrink": (_X(), {}, "Out"),
    "thresholded_relu": (_X(), {"threshold": 0.7}, "Out"),
    "prelu": ({"X": [_randn(2, 3, 4, 4)],
               "Alpha": [np.array([0.1, 0.2, 0.3], np.float32)]},
              {"mode": "channel"}, "Out"),
    "selu": (_X(), {}, "Out"),
    "maxout": ({"X": [_randn(2, 6, 3, 3)]}, {"groups": 2}, "Out"),
}

_R = lambda: {"X": [_randn(3, 4, 5)]}
REDUCE = {
    "reduce_mean": (_R(), {"dim": [1], "keep_dim": False,
                           "reduce_all": False}, "Out"),
    "reduce_max": (_R(), {"dim": [-1], "keep_dim": True,
                          "reduce_all": False}, "Out"),
    "reduce_min": (_R(), {"dim": [0, 2], "keep_dim": False,
                          "reduce_all": False}, "Out"),
    "reduce_prod": ({"X": [_pos(3, 4, 5)]}, {"dim": [0, 2], "keep_dim": True,
                                              "reduce_all": False}, "Out"),
}

OTHER = {
    "label_smooth": ({"X": [np.eye(6, dtype=np.float32)[
        _rng(0).randint(0, 6, 10)]]}, {"epsilon": 0.1}, "Out"),
}

CASES = dict(COMPARE, **MATH, **ACTIVATIONS, **REDUCE, **OTHER)
# the elementwise ops and activations also run in bf16
BF16_OPS = sorted(ACTIVATIONS) + ["elementwise_max", "elementwise_min",
                                  "elementwise_pow", "elementwise_mod",
                                  "elementwise_floordiv"]
EXACT = {"ceil", "floor", "round", "elementwise_max", "elementwise_min"}


def test_the_cases_are_the_ported_lowerings():
    """Every lowering this slice ports has a case here (the optimizer ops
    are in test_torch_optimizer_zoo.py), and the port holds 311 with
    fusion_ops.py's 14, 297 before them (125,
    test_torch_loss_ops.py's 14, test_torch_tensor_ops.py's 40,
    test_torch_nn_ops.py's 24, test_torch_array_ops.py's 14,
    test_torch_sequence_ops.py's 15, test_torch_rnn_ops.py's 8,
    test_torch_decode_ops.py's 6 and test_torch_ctc_pool_ops.py's 9)."""
    assert (len(COMPARE), len(MATH), len(ACTIVATIONS), len(REDUCE),
            len(OTHER)) == (11, 13, 31, 4, 1)
    assert all(treg.has_lowering(op) and jreg.has_lowering(op)
               for op in CASES)
    assert len(treg._LOWERINGS) == 311


@pytest.mark.parametrize("op", sorted(CASES))
def test_forward_matches_jax(op):
    arrays, attrs, slot = CASES[op]
    want, got = _run(op, arrays, attrs)
    assert set(got) >= {slot}
    for s in want:
        if s in got:
            _close(got[s][0], want[s][0], exact=op in EXACT, err_msg=s)


@pytest.mark.parametrize("op", BF16_OPS)
def test_bf16_forward_matches_jax_in_f32(op):
    """The port in bf16 keeps bf16 and lies within one bf16 ulp of the JAX
    lowering run in f32 on the same bf16 values."""
    arrays, attrs, slot = CASES[op]
    _, got = _run(op, arrays, attrs, "bfloat16")
    assert got[slot][0].dtype == torch.bfloat16
    rounded = {k: [_bf16(a) if k in ("X", "Y") else a for a in v]
               for k, v in arrays.items()}
    want, _ = _run(op, rounded, attrs)
    _close(got[slot][0], want[slot][0], "bfloat16", exact=op in EXACT)


def _float_keys(arrays):
    return [(k, i) for k, v in arrays.items() for i, a in enumerate(v)
            if a.dtype == np.float32]


def _jax_fn(op, arrays, attrs, slot):
    """The JAX lowering's ``slot`` output as a function of the case's float
    inputs, and those inputs."""
    jin, _ = _inputs(arrays, "float32")
    keys = _float_keys(arrays)

    def fn(*xs):
        ins = {k: list(v) for k, v in jin.items()}
        for (k, i), x in zip(keys, xs):
            ins[k][i] = x
        return jreg.get_lowering(op)(jreg.LoweringContext(), ins,
                                     attrs)[slot][0]
    return fn, [jin[k][i] for k, i in keys]


def _cot(shape, seed=9):
    return _rng(seed).randn(*shape).astype(np.float32)


def _port_grads(op, arrays, attrs, slot, cot):
    """Autograd of the port's lowering: d<slot output> . cot with respect to
    every float input."""
    _, tin = _inputs(arrays, "float32")
    tins = {k: list(v) for k, v in tin.items()}
    leaves = []
    for k, i in _float_keys(arrays):
        tins[k][i] = tins[k][i].clone().requires_grad_(True)
        leaves.append(tins[k][i])
    tout = treg.get_lowering(op)(treg.LoweringContext("cpu"), tins,
                                 attrs)[slot][0]
    got = torch.autograd.grad(tout, leaves, torch.from_numpy(cot),
                              allow_unused=True)
    return [torch.zeros_like(leaf) if g is None else g
            for leaf, g in zip(leaves, got)]


def _vjp_both(op, arrays, attrs, slot):
    """[(input, port gradient, JAX gradient)] of one case, the JAX side by
    ``jax.vjp`` of its lowering."""
    fn, xs = _jax_fn(op, arrays, attrs, slot)
    out, vjp = jax.vjp(fn, *xs)
    cot = _cot(out.shape)
    want = vjp(jnp.asarray(cot))
    got = _port_grads(op, arrays, attrs, slot, cot)
    return [("%s[%d]" % key, g, w)
            for key, g, w in zip(_float_keys(arrays), got, want)]


GRAD_OPS = sorted(op for op in CASES if not jreg.is_no_grad(op))


@pytest.fixture(scope="module")
def jax_vjps():
    """{op: (cotangent, [gradient of each float input])} for every case of
    GRAD_OPS, the JAX side taken in one jitted function (one compile in
    place of one eager dispatch chain a case)."""
    fns, args, cots = [], [], []
    for op in GRAD_OPS:
        arrays, attrs, slot = CASES[op]
        fn, xs = _jax_fn(op, arrays, attrs, slot)
        fns.append(fn)
        args.append(xs)
        cots.append(_cot(jax.eval_shape(fn, *xs).shape))

    @jax.jit
    def all_vjps(args, cots):
        return [jax.vjp(fn, *xs)[1](c) for fn, xs, c in zip(fns, args, cots)]
    grads = all_vjps(args, [jnp.asarray(c) for c in cots])
    return {op: (c, g) for op, c, g in zip(GRAD_OPS, cots, grads)}


@pytest.mark.parametrize("op", GRAD_OPS)
def test_gradient_matches_jax_vjp(op, jax_vjps):
    arrays, attrs, slot = CASES[op]
    cot, want = jax_vjps[op]
    got = _port_grads(op, arrays, attrs, slot, cot)
    for key, g, w in zip(_float_keys(arrays), got, want):
        _close(g, w, err_msg="%s[%d]" % key)


# --------------------------------------------------------------------------
# ties, integer and rounding semantics
# --------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["elementwise_max", "elementwise_min"])
def test_max_min_ties_split_the_gradient(op):
    """Where x == y, jnp.maximum/minimum give each side half the gradient;
    so does the port."""
    x = _randn(4, 6)
    y = x.copy()
    y[::2] = _randn(2, 6, seed=1)
    grads = _vjp_both(op, {"X": [x], "Y": [y]}, {"axis": -1}, "Out")
    for name, got, want in grads:
        _close(got, want, exact=True, err_msg=name)
    cot = _rng(9).randn(4, 6).astype(np.float32)
    np.testing.assert_array_equal(_np(grads[0][1])[1::2], cot[1::2] / 2)


@pytest.mark.parametrize("op", ["reduce_max", "maxout"])
def test_tied_maxima_share_the_gradient(op):
    x = np.round(_randn(2, 6, 3, 3, scale=0.6))
    attrs = {"groups": 3} if op == "maxout" else \
        {"dim": [1], "keep_dim": False, "reduce_all": False}
    assert len(np.unique(x)) < x.size / 4       # many ties
    for name, got, want in _vjp_both(op, {"X": [x]}, attrs, "Out"):
        _close(got, want, err_msg=name)


@pytest.mark.parametrize("op", ["relu6", "brelu", "hard_sigmoid"])
def test_clip_at_a_bound_splits_the_gradient(op):
    """jnp.clip gives half the gradient where x equals a bound (torch.clamp
    would give all of it)."""
    attrs = {"relu6": {"threshold": 6.0},
             "brelu": {"t_min": -1.0, "t_max": 2.0},
             "hard_sigmoid": {"slope": 0.25, "offset": 0.5}}[op]
    x = np.array([[0.0, 6.0, -1.0, 2.0, -2.0, 1.0, 3.0, 7.0]], np.float32)
    for name, got, want in _vjp_both(op, {"X": [x]}, attrs, "Out"):
        _close(got, want, exact=True, err_msg=name)


@pytest.mark.parametrize("dtype", ["int64", "float32"])
@pytest.mark.parametrize("op", ["elementwise_mod", "elementwise_floordiv"])
def test_mod_and_floordiv_take_the_divisors_sign(op, dtype):
    """jnp.mod takes the divisor's sign (torch.remainder, not torch.fmod);
    jnp.floor_divide rounds toward minus infinity. Without x64 the JAX
    package computes int64 as int32; the values are the same."""
    x = np.array([[7, -7, 7, -7, 6, -6, 0, 5]], dtype)
    y = np.array([[3, 3, -3, -3, 4, 4, 3, -2]], dtype)
    want, got = _run(op, {"X": [x], "Y": [y]}, {"axis": -1})
    _close(got["Out"][0], want["Out"][0], exact=True)
    ref = np.mod(x, y) if op == "elementwise_mod" else np.floor_divide(x, y)
    np.testing.assert_array_equal(_np(got["Out"][0]), ref)


@pytest.mark.parametrize("exclusive,reverse", [(False, False), (True, False),
                                               (False, True), (True, True)])
def test_cumsum_variants_match_jax(exclusive, reverse):
    """With exclusive and reverse both set, the JAX lowering's reverse
    branch recomputes the sum from x and drops ``exclusive``; the port
    mirrors it (ROADMAP Queue 3), so the result is the inclusive reverse
    sum."""
    x = _randn(3, 5, 4)
    attrs = {"axis": -2, "exclusive": exclusive, "reverse": reverse}
    want, got = _run("cumsum", {"X": [x]}, attrs)
    _close(got["Out"][0], want["Out"][0])
    if exclusive and reverse:
        inclusive = np.flip(np.cumsum(np.flip(x, 1), 1), 1)
        _close(got["Out"][0], inclusive)


def test_cos_sim_broadcasts_a_one_row_y():
    x, y = _randn(6, 8), _randn(1, 8, seed=1)
    want, got = _run("cos_sim", {"X": [x], "Y": [y]}, {})
    for s in ("Out", "XNorm", "YNorm"):
        _close(got[s][0], want[s][0], err_msg=s)
    assert tuple(got["YNorm"][0].shape) == (6, 1)
    for name, g, w in _vjp_both("cos_sim", {"X": [x], "Y": [y]}, {}, "Out"):
        _close(g, w, err_msg=name)


def test_isfinite_reduces_every_input_to_one_bool():
    x = _randn(3, 4)
    y = _randn(5, seed=1)
    y[2] = np.inf
    for arrays in ({"X": [x]}, {"X": [x, y]}, {"X": [x, np.full(2, np.nan,
                                                               np.float32)]}):
        want, got = _run("isfinite", arrays, {})
        assert tuple(got["Out"][0].shape) == (1,)
        _close(got["Out"][0], want["Out"][0])


def test_is_empty_on_an_empty_input():
    want, got = _run("is_empty", {"X": [np.zeros((0, 3), np.float32)]}, {})
    assert bool(got["Out"][0]) and bool(want["Out"][0])


@pytest.mark.parametrize("mode,alpha", [("all", (1,)), ("element", (1, 3, 4,
                                                                    4))])
def test_prelu_modes_match_jax(mode, alpha):
    arrays = {"X": [_randn(2, 3, 4, 4)],
              "Alpha": [_randn(*alpha, seed=1, scale=0.3)]}
    want, got = _run("prelu", arrays, {"mode": mode})
    _close(got["Out"][0], want["Out"][0])
    for name, g, w in _vjp_both("prelu", arrays, {"mode": mode}, "Out"):
        _close(g, w, err_msg=name)


def test_prelu_keeps_bf16_where_jax_promotes():
    """A bf16 x times the f32 alpha parameter: the JAX lowering returns f32
    (type promotion), the port x's dtype, as the layer declares it
    (ROADMAP Queue 3)."""
    arrays, attrs, _ = ACTIVATIONS["prelu"]
    want, got = _run("prelu", arrays, attrs, "bfloat16")
    assert want["Out"][0].dtype == jnp.float32
    assert got["Out"][0].dtype == torch.bfloat16
    _close(got["Out"][0], want["Out"][0], "bfloat16")


def test_label_smooth_with_a_prior():
    x = np.eye(5, dtype=np.float32)[_rng(0).randint(0, 5, 7)]
    prior = _rng(1).dirichlet(np.ones(5)).astype(np.float32)[None]
    want, got = _run("label_smooth", {"X": [x], "PriorDist": [prior]},
                     {"epsilon": 0.2})
    _close(got["Out"][0], want["Out"][0])


# --------------------------------------------------------------------------
# layers and programs: op for op the JAX package's, gradients through
# append_backward against the JAX executor
# --------------------------------------------------------------------------

def _signature(program):
    return [(op.type, dict(op.inputs), dict(op.outputs),
             sorted((k, repr(v)) for k, v in op.attrs.items()))
            for op in program.global_block().ops]


def _chain(fl):
    """Every new differentiable layer in one small network."""
    L = fl.layers
    x = L.data(name="x", shape=[3, 4, 4], dtype="float32",
               stop_gradient=False)
    w = L.data(name="w", shape=[3, 4, 4], dtype="float32",
               stop_gradient=False)
    h = L.prelu(x, "channel")
    h = L.elementwise_max(h, L.swish(w, beta=1.2))
    h = L.elementwise_min(h, L.elu(x, 0.5))
    h = L.maxout(h + L.relu6(w * 3.0, threshold=2.0), groups=3)
    f = L.reshape(h, [-1, 16])
    g = L.cumsum(L.leaky_relu(f, alpha=0.1), axis=1)
    g = L.elementwise_pow(L.softplus(g) + 0.5, L.scale(L.tanh(g), scale=0.5))
    c = L.cos_sim(g, L.abs(f))
    s = L.reduce_mean(L.reduce_max(g, dim=[1], keep_dim=True)) + \
        L.reduce_sum(L.reduce_prod(L.sigmoid(g), dim=[1])) + \
        L.reduce_min(L.selu(f)) + L.mean(c) + \
        L.mean(L.hard_sigmoid(L.cos(g))) + L.mean(L.exp(-L.square(f))) + \
        L.mean(L.stanh(L.sin(g))) + L.mean(L.log(L.sqrt(L.abs(f) + 1.0)))
    return s


def _program(fl, build):
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        out = build(fl)
        fl.append_backward(out)
    return main, startup, out


def test_layers_build_the_jax_program_and_its_gradients():
    """The layers build the JAX package's program op for op, backward
    included; the loss and the gradients of x, w and the prelu alpha
    match the JAX executor's."""
    jm, js, jout = _program(jfluid, _chain)
    tm, ts, tout = _program(tfluid, _chain)
    assert _signature(jm) == _signature(tm)
    assert _signature(js) == _signature(ts)
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    texe.run(ts, scope=tscope)
    alpha = [p.name for p in jm.all_parameters()]
    tfluid.params_from_numpy({n: np.asarray(jscope.get(n)) for n in alpha},
                             tscope, "cpu")
    feed = {"x": _randn(2, 3, 4, 4), "w": _randn(2, 3, 4, 4, seed=1)}
    fetch = [jout.name, "x@GRAD", "w@GRAD"] + [n + "@GRAD" for n in alpha]
    want = jexe.run(jm, feed=feed, fetch_list=fetch, scope=jscope)
    got = texe.run(tm, feed=feed, fetch_list=fetch, scope=tscope)
    for n, g, w in zip(fetch, got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max(), err_msg=n)


def _compare_net(fl):
    L = fl.layers
    a = L.data(name="a", shape=[4], dtype="float32")
    b = L.data(name="b", shape=[4], dtype="float32")
    outs = [L.less_than(a, b), L.less_equal(a, b), L.greater_than(a, b),
            L.greater_equal(a, b), L.equal(a, b), L.not_equal(a, b),
            a < b, a <= b, a > b, a >= b]
    outs += [L.logical_and(outs[0], outs[4]), L.logical_or(outs[0], outs[4]),
             L.logical_xor(outs[1], outs[3]), L.logical_not(outs[2]),
             L.isfinite(a), L.is_empty(b)]
    outs += [L.elementwise_mod(a, b), L.elementwise_floordiv(a, b),
             L.floor(a), L.ceil(a), L.round(a), L.sign(a),
             L.cumsum(a, axis=1, exclusive=True),
             L.increment(L.assign(a), 2.0, in_place=False),
             L.clip(a, -0.5, 0.5), L.clip_by_norm(a, 1.0), -a, 2.0 ** b,
             a ** 2.0, 1.0 / (b + 3.0), L.label_smooth(L.abs(a), epsilon=0.3),
             L.ones([2, 3], "float32"), L.zeros([2], "int64"),
             L.fill_constant([1], "float32", 1.5)]
    return outs


def test_compare_layers_and_sugar_build_the_jax_program_and_values():
    """The comparison layers declare a bool output; the comparison sugar
    (a < b) declares a's dtype, in both packages; the values agree."""
    def build(fl):
        main, startup = fl.Program(), fl.Program()
        with fl.unique_name.guard(), fl.program_guard(main, startup):
            outs = _compare_net(fl)
        return main, outs

    (jm, jouts), (tm, touts) = build(jfluid), build(tfluid)
    assert _signature(jm) == _signature(tm)
    assert [(v.name, v.dtype) for v in jouts] == \
        [(v.name, v.dtype) for v in touts]
    assert touts[0].dtype == "bool" and touts[6].dtype == "float32"
    a = np.round(_randn(3, 4, scale=2.0)) + 0.25
    b = np.round(_randn(3, 4, seed=1, scale=2.0))
    b[b == 0] = 1.0
    feed = {"a": a, "b": b}
    want = jfluid.Executor(jfluid.CPUPlace()).run(
        jm, feed=feed, fetch_list=jouts, scope=jfluid.Scope())
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tm, feed=feed, fetch_list=touts, scope=tfluid.Scope())
    for v, g, w in zip(touts, got, want):
        _close(g, np.asarray(w), err_msg=v.name)


def test_tensor_layers_build_the_jax_program():
    def build(fl):
        main, startup = fl.Program(), fl.Program()
        with fl.unique_name.guard(), fl.program_guard(main, startup):
            L = fl.layers
            t = L.create_tensor("float32", name="t")
            p = L.create_parameter([3, 2], "float32", name="cp")
            g = L.create_global_var([2], 0.5, "float32", persistable=True,
                                    name="gv")
            out = L.assign(L.elementwise_add(L.reduce_sum(p), g), t)
        return main, startup, out

    (jm, js, jo), (tm, ts, to) = build(jfluid), build(tfluid)
    assert _signature(jm) == _signature(tm)
    assert _signature(js) == _signature(ts)
    assert [(v.name, v.dtype, v.persistable) for v in
            jm.global_block().vars.values()] == \
        [(v.name, v.dtype, v.persistable) for v in
         tm.global_block().vars.values()]
    # assign of a numpy array: the assign_value op, as the JAX package
    # builds it
    arrays = []
    for fl in (jfluid, tfluid):
        main = fl.Program()
        with fl.unique_name.guard(), fl.program_guard(main, fl.Program()):
            fl.layers.assign(np.arange(3, dtype=np.float32))
        arrays.append(main)
    assert _signature(arrays[0]) == _signature(arrays[1])
    assert [op.type for op in arrays[1].global_block().ops] == \
        ["assign_value"]


def test_sum_over_an_unknown_shape_leaves_it_unknown():
    """sum over an input whose build-time shape shape inference could not
    size (the mean square of a reshape of a [-1, -1, 1] input): Out's
    shape stays None in both packages (the port sized it from the other
    inputs before), the programs are op for op and var for var the same,
    and the values run and agree."""
    def build(fl):
        main, startup = fl.Program(), fl.Program()
        with fl.unique_name.guard(), fl.program_guard(main, startup):
            L = fl.layers
            a = L.data(name="a", shape=[3], dtype="float32")
            c = L.data(name="c", shape=[-1, 1], dtype="float32")
            out = L.sums([L.mean(a), L.mean(L.square(L.reshape(c,
                                                               [-1, 12])))])
        return main, out

    (jm, jo), (tm, to) = build(jfluid), build(tfluid)
    assert jo.shape is None and to.shape is None
    assert _signature(jm) == _signature(tm)
    assert [(v.name, v.shape, v.dtype) for v in
            jm.global_block().vars.values()] == \
        [(v.name, v.shape, v.dtype) for v in tm.global_block().vars.values()]
    rng = np.random.RandomState(5)
    feed = {"a": rng.randn(2, 3).astype("float32"),
            "c": rng.randn(2, 6, 1).astype("float32")}
    want, = jfluid.Executor(jfluid.CPUPlace()).run(jm, feed=feed,
                                                   fetch_list=[jo])
    got, = tfluid.Executor(tfluid.CPUPlace()).run(tm, feed=feed,
                                                  fetch_list=[to])
    np.testing.assert_allclose(got, want, rtol=1e-6)
