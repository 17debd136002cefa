"""The lowerings that BERT and DeepFM add to the port, each against the JAX
package's lowering of the same op on the same inputs, on the CPU.

Inputs come from seeded numpy and enter both packages as the same values
(bf16 inputs are the f32 draws rounded to nearest even by each).

Tolerances. float32: |got - want| <= 1e-6 * |want| + 1e-6 * max |want|
(the two libraries' tanh, exp and log1p differ by a few ulp, and sums run
in other orders; the second term covers elements near zero, where an f32
formula such as gelu's 1 + tanh cancels). bfloat16: one bf16 ulp,
2^-7 * |want|, in place of the first term; the activations are held
against the JAX lowering in f32 on the same bf16 values (see their test).
Exact ops (slicing, one_hot, concat, flatten, integer histograms) must be
equal. Gradients (f32): the JAX lowering's ``jax.vjp`` against the port
lowering's autograd at the f32 tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.fluid.ops import registry as jreg
import paddle_tpu_torch.fluid  # noqa: F401
from paddle_tpu_torch.fluid.ops import registry as treg

BF16_ULP = 2.0 ** -7


def _np(x):
    """A torch or JAX array as float64 (or int64) numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        x = x.float() if x.dtype == torch.bfloat16 else x
        x = x.numpy()
    else:
        x = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                       else x)
    return x.astype(np.int64 if x.dtype.kind in "iub" else np.float64)


def _inputs(arrays, dtype):
    """{slot: [numpy]} as JAX and as torch inputs of `dtype` (floating
    arrays only; integer arrays keep their dtype)."""
    def j(a):
        a = jnp.asarray(a)
        return a.astype(jnp.bfloat16) if dtype == "bfloat16" and \
            a.dtype == jnp.float32 else a

    def t(a):
        a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(torch.bfloat16) if dtype == "bfloat16" and \
            a.dtype == torch.float32 else a
    return ({k: [j(a) for a in v] for k, v in arrays.items()},
            {k: [t(a) for a in v] for k, v in arrays.items()})


def _run(op, arrays, attrs, dtype="float32"):
    jin, tin = _inputs(arrays, dtype)
    want = jreg.get_lowering(op)(jreg.LoweringContext(), jin, attrs)
    got = treg.get_lowering(op)(treg.LoweringContext("cpu"), tin, attrs)
    return want, got


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    rtol = BF16_ULP if dtype == "bfloat16" else 1e-6
    bound = rtol * np.abs(want) + 1e-6 * np.abs(want).max()
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


def _randn(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["gelu", "tanh", "sigmoid", "square"])
def test_activation_matches_jax(op, dtype):
    """bfloat16: the port computes each activation in f32 and rounds once,
    so it lies within one bf16 ulp of the JAX lowering run in f32 on the
    same bf16 inputs. The JAX lowering run in bf16 rounds every op of its
    formula (jax.nn.sigmoid is 2 ulp off at x = -0.13672; in jax.nn.gelu,
    1 + tanh cancels to 0 at x = -3.0625), so it is not the reference
    there."""
    x = _randn(8, 64, scale=3.0)
    _, got = _run(op, {"X": [x]}, {}, dtype)
    if dtype == "bfloat16":
        x = _np(torch.from_numpy(x).to(torch.bfloat16)).astype(np.float32)
    want, _ = _run(op, {"X": [x]}, {})
    _close(got["Out"][0], want["Out"][0], dtype)


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to the tanh approximation; the erf form differs
    from it by up to ~1e-3 near |x| = 2, which the f32 tolerance rejects."""
    x = np.linspace(-4, 4, 801, dtype=np.float32)[None]
    want, got = _run("gelu", {"X": [x]}, {})
    _close(got["Out"][0], want["Out"][0], "float32")
    erf = torch.nn.functional.gelu(torch.from_numpy(x))
    with pytest.raises(AssertionError):
        _close(erf, want["Out"][0], "float32")


@pytest.mark.parametrize("axes,starts,ends", [
    ([1], [0], [1]),                    # BERT's [CLS] slice
    ([1], [-3], [100]),                 # negative start, end past the dim
    ([0, 2], [-100, 1], [1, -1]),       # start before 0, negative end
    ([1], [5], [2]),                    # empty
])
def test_slice_matches_jax(axes, starts, ends):
    x = _randn(3, 6, 5)
    attrs = {"axes": axes, "starts": starts, "ends": ends}
    want, got = _run("slice", {"Input": [x]}, attrs)
    np.testing.assert_array_equal(_np(got["Out"][0]), _np(want["Out"][0]))


@pytest.mark.parametrize("shape", [(4, 5, 1), (4, 5)])
def test_one_hot_matches_jax(shape):
    """float32, the trailing size-1 axis squeezed, an id outside [0,
    depth) a row of zeros."""
    ids = np.random.RandomState(1).randint(0, 7, shape).astype(np.int64)
    ids.flat[0], ids.flat[1] = 7, -1
    want, got = _run("one_hot", {"X": [ids]}, {"depth": 7})
    assert got["Out"][0].dtype == torch.float32
    np.testing.assert_array_equal(_np(got["Out"][0]), _np(want["Out"][0]))
    assert treg.is_no_grad("one_hot")


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_concat_matches_jax(axis):
    xs = [_randn(4, 3, seed=s) for s in range(3)]
    want, got = _run("concat", {"X": xs}, {"axis": axis})
    np.testing.assert_array_equal(_np(got["Out"][0]), _np(want["Out"][0]))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_flatten2_matches_jax(axis):
    x = _randn(4, 3, 5)
    want, got = _run("flatten2", {"X": [x]}, {"axis": axis})
    np.testing.assert_array_equal(_np(got["Out"][0]), _np(want["Out"][0]))
    assert tuple(got["XShape"][0].shape) == tuple(want["XShape"][0].shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("yshape,axis", [((4, 3, 5), -1), ((5,), -1),
                                         ((3,), 1), ((3, 5), 1), ((4,), 0),
                                         ((1,), -1)])
def test_elementwise_sub_matches_jax(yshape, axis, dtype):
    want, got = _run("elementwise_sub",
                     {"X": [_randn(4, 3, 5)], "Y": [_randn(*yshape, seed=1)]},
                     {"axis": axis}, dtype)
    np.testing.assert_array_equal(_np(got["Out"][0]), _np(want["Out"][0]))


def test_scalar_minus_variable_is_the_reversed_sub():
    """`1.0 - prob` (DeepFM's AUC input): X a [1] constant, Y [B, 1]."""
    want, got = _run("elementwise_sub",
                     {"X": [np.ones(1, np.float32)],
                      "Y": [_randn(6, 1)]}, {"axis": -1})
    np.testing.assert_array_equal(_np(got["Out"][0]), _np(want["Out"][0]))


@pytest.mark.parametrize("attrs", [
    {"dim": [1, 2], "keep_dim": False, "reduce_all": False},
    {"dim": [1], "keep_dim": True, "reduce_all": False},
    {"dim": [-1], "keep_dim": False, "reduce_all": False},
    {"dim": [0], "keep_dim": False, "reduce_all": True},
    {"dim": [0], "keep_dim": True, "reduce_all": True},
])
def test_reduce_sum_matches_jax(attrs):
    want, got = _run("reduce_sum", {"X": [_randn(4, 26, 16)]}, attrs)
    _close(got["Out"][0], want["Out"][0], "float32")


@pytest.mark.parametrize("normalize", [False, True])
def test_sigmoid_ce_matches_jax(normalize):
    x = _randn(16, 3, scale=4.0)
    label = np.random.RandomState(2).randint(0, 2, (16, 3)) \
        .astype(np.float32)
    label[0, 0] = label[5, 2] = -100.0          # ignored
    want, got = _run("sigmoid_cross_entropy_with_logits",
                     {"X": [x], "Label": [label]},
                     {"ignore_index": -100, "normalize": normalize})
    _close(got["Out"][0], want["Out"][0], "float32")
    assert _np(got["Out"][0])[0, 0] == 0.0


def test_auc_over_three_calls_matches_jax():
    """The histograms carried from call to call in both packages: equal
    counts, and the AUC at the f32 tolerance. The port's histograms are
    int64 (the layer's dtype), the JAX package's int32 (no x64): values
    are compared, not dtypes."""
    rng = np.random.RandomState(4)
    n = 64
    jpos = jneg = np.zeros(4096, np.int32)
    tpos = tneg = torch.zeros(4096, dtype=torch.int64)
    for _ in range(3):
        prob = rng.uniform(0, 1, (n, 1)).astype(np.float32)
        prob[:3, 0] = [0.0, 1.0, 0.5]           # the end buckets
        predict = np.concatenate([1.0 - prob, prob], axis=1)
        label = rng.randint(0, 2, (n, 1)).astype(np.int64)
        attrs = {"num_thresholds": 4095, "curve": "ROC"}
        want = jreg.get_lowering("auc")(
            jreg.LoweringContext(),
            {"Predict": [jnp.asarray(predict)], "Label": [jnp.asarray(label)],
             "StatPos": [jnp.asarray(jpos)], "StatNeg": [jnp.asarray(jneg)]},
            attrs)
        got = treg.get_lowering("auc")(
            treg.LoweringContext("cpu"),
            {"Predict": [torch.from_numpy(predict)],
             "Label": [torch.from_numpy(label)],
             "StatPos": [tpos], "StatNeg": [tneg]}, attrs)
        jpos, jneg = want["StatPosOut"][0], want["StatNegOut"][0]
        tpos, tneg = got["StatPosOut"][0], got["StatNegOut"][0]
        np.testing.assert_array_equal(_np(tpos), _np(jpos))
        np.testing.assert_array_equal(_np(tneg), _np(jneg))
        _close(got["AUC"][0], want["AUC"][0], "float32")
    assert int(tpos.sum() + tneg.sum()) == 3 * n
    assert 0.0 < float(got["AUC"][0]) < 1.0


# ---- gradients: jax.vjp of the JAX lowering vs the port's autograd ----

GRAD_CASES = {
    "gelu": ({"X": [_randn(8, 32, scale=3.0)]}, {}, "X"),
    "tanh": ({"X": [_randn(8, 32, scale=2.0)]}, {}, "X"),
    "sigmoid": ({"X": [_randn(8, 32, scale=3.0)]}, {}, "X"),
    "square": ({"X": [_randn(8, 32)]}, {}, "X"),
    "slice": ({"Input": [_randn(3, 6, 5)]},
              {"axes": [1], "starts": [0], "ends": [1]}, "Input"),
    "reduce_sum": ({"X": [_randn(4, 6, 5)]},
                   {"dim": [1], "keep_dim": False, "reduce_all": False}, "X"),
    "sigmoid_cross_entropy_with_logits": (
        {"X": [_randn(16, 1, scale=4.0)],
         "Label": [np.random.RandomState(3).randint(0, 2, (16, 1))
                   .astype(np.float32)]}, {"ignore_index": -100}, "X"),
    "flatten2": ({"X": [_randn(4, 3, 5)]}, {"axis": 1}, "X"),
}


@pytest.mark.parametrize("op", sorted(GRAD_CASES))
def test_gradient_matches_jax_vjp(op):
    arrays, attrs, slot = GRAD_CASES[op]
    jin, tin = _inputs(arrays, "float32")

    def jfn(x):
        return jreg.get_lowering(op)(jreg.LoweringContext(),
                                     dict(jin, **{slot: [x]}), attrs)["Out"][0]
    out, vjp = jax.vjp(jfn, jin[slot][0])
    cot = np.random.RandomState(9).randn(*out.shape).astype(np.float32)
    want, = vjp(jnp.asarray(cot))
    leaf = tin[slot][0].clone().requires_grad_(True)
    tout = treg.get_lowering(op)(treg.LoweringContext("cpu"),
                                 dict(tin, **{slot: [leaf]}), attrs)["Out"][0]
    got, = torch.autograd.grad(tout, leaf, torch.from_numpy(cot))
    _close(got, want, "float32")


# ---- the sparse row gradient and its consumers ----

def _ids_with_repeats(n, vocab, seed):
    ids = np.random.RandomState(seed).randint(0, vocab, (n, 1))
    ids[1], ids[5] = ids[0], ids[0]                 # one id three times
    return ids.astype(np.int64)


def test_sparse_lookup_table_grad_is_the_values_rows_pair():
    ids = _ids_with_repeats(12, 10, 0)
    arrays = {"W": [_randn(10, 4)], "Ids": [ids], "Out@GRAD": [_randn(12, 4)]}
    want, got = _run("lookup_table_grad", arrays, {"is_sparse": True})
    np.testing.assert_array_equal(_np(got["W@GRAD"][0]),
                                  _np(want["W@GRAD"][0]))
    np.testing.assert_array_equal(_np(got["W@GRAD@ROWS"][0]),
                                  _np(want["W@GRAD@ROWS"][0]))
    # densified, the pair is the dense grad
    dense = treg.get_lowering("selected_rows_densify")(
        treg.LoweringContext("cpu"),
        {"X": got["W@GRAD"], "Rows": got["W@GRAD@ROWS"],
         "Ref": [torch.zeros(10, 4)]}, {})["Out"][0]
    _, full = _run("lookup_table_grad", arrays, {"is_sparse": False})
    np.testing.assert_array_equal(_np(dense), _np(full["W@GRAD"][0]))


def test_selected_rows_densify_matches_jax():
    rows = np.array([3, 1, 3, -1, 0, 3], np.int64)   # repeats, a wrap
    want, got = _run("selected_rows_densify",
                     {"X": [_randn(6, 4)], "Rows": [rows],
                      "Ref": [np.zeros((5, 4), np.float32)]}, {})
    _close(got["Out"][0], want["Out"][0], "float32")


def _sparse_update_inputs(op, seed):
    rng = np.random.RandomState(seed)
    vocab, dim, n = 12, 4, 9
    arrays = {"Param": [_randn(vocab, dim, seed=seed)],
              "Grad": [_randn(n, dim, seed=seed + 1)],
              "GradRows": [_ids_with_repeats(n, vocab, seed).reshape(-1)],
              "LearningRate": [np.array([0.05], np.float32)]}
    if op == "adam":
        arrays.update(
            Moment1=[rng.randn(vocab, dim).astype(np.float32) * 0.1],
            Moment2=[np.abs(rng.randn(vocab, dim)).astype(np.float32) * 0.1],
            Beta1Pow=[np.array([0.9 ** 3], np.float32)],
            Beta2Pow=[np.array([0.999 ** 3], np.float32)])
    return arrays


@pytest.mark.parametrize("op,lazy", [("sgd", False), ("adam", False),
                                     ("adam", True)])
def test_sparse_update_matches_jax(op, lazy):
    """Repeated ids in GradRows: sgd folds them into its scatter, lazy adam
    merges them first and moves only the touched rows, non-lazy adam
    densifies the pair and decays every row's moments."""
    arrays = _sparse_update_inputs(op, 5)
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
             "lazy_mode": lazy}
    want, got = _run(op, arrays, attrs)
    assert set(got) == set(want)
    for slot in want:
        _close(got[slot][0], want[slot][0], "float32")
    if lazy:
        untouched = np.setdiff1d(np.arange(12), arrays["GradRows"][0])
        for slot, src in (("ParamOut", "Param"), ("Moment1Out", "Moment1")):
            np.testing.assert_array_equal(
                _np(got[slot][0])[untouched], arrays[src][0][untouched])


# ---- Variable operator sugar: the same ops as the JAX package's ----

SUGAR = {
    "add": lambda a, b: a + b, "radd": lambda a, b: 2.0 + a,
    "sub": lambda a, b: a - b, "rsub": lambda a, b: 1.0 - a,
    "mul": lambda a, b: a * 3.0, "rmul": lambda a, b: 3.0 * a,
    "truediv": lambda a, b: a / b,
}


@pytest.mark.parametrize("name", sorted(SUGAR))
def test_variable_operator_sugar_matches_jax_program(name):
    import paddle_tpu.fluid as jfluid
    import paddle_tpu_torch.fluid as tfluid

    def build(fl):
        main, startup = fl.Program(), fl.Program()
        with fl.unique_name.guard(), fl.program_guard(main, startup):
            a = fl.layers.data(name="a", shape=[3], dtype="float32")
            b = fl.layers.data(name="b", shape=[3], dtype="float32")
            out = SUGAR[name](a, b)
        block = main.global_block()
        return out.name, [(op.type, dict(op.inputs), dict(op.outputs),
                           sorted((k, repr(v)) for k, v in op.attrs.items()))
                          for op in block.ops], \
            [(v.name, v.shape, v.dtype) for v in block.vars.values()]
    assert build(jfluid) == build(tfluid)
