"""The lowerings ResNet adds to the port (conv2d, pool2d, batch_norm and
batch_norm_grad, momentum and its group lowering, top_k, accuracy), each
against the JAX package's lowering of the same op on the same inputs, on
the CPU. Inputs come from seeded numpy and enter both packages as the same
values (bf16 inputs are the f32 draws rounded to nearest even by each).

Tolerances, relative to the largest magnitude of the JAX output:
float32 1e-5 (sums in other orders; batch_norm's gradients 1e-4, where
E[x^2] - E[x]^2 and the terms of dx cancel, dx relative to the size of its
terms, dy * scale * rsqrt(var + eps)); bfloat16 2^-7, one bf16 ulp at
the largest value (both libraries accumulate in f32 and round once, but
round the sums of pool windows and of conv products in other orders).
Gradients: the JAX lowering's ``jax.vjp`` against the port lowering's
autograd (batch_norm: the two grad ops). Exact ops (max pooling, top_k's
indices, accuracy's counts) must be equal, and so must the momentum group
lowering and the op-by-op one, bit for bit.

The four traps a straightforward port falls into are pinned: the biased
running variance and SavedVariance (F.batch_norm updates with the unbiased
estimate), top_k's order among ties (torch.topk promises none), the max-pool
gradient of a tied window (to its first maximum), and accuracy's dtypes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu.fluid  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.fluid.ops import registry as jreg
import paddle_tpu_torch.fluid  # noqa: F401
from paddle_tpu_torch.fluid.interop import tensor_from_numpy
from paddle_tpu_torch.fluid.ops import nn_ops, optimizer_ops
from paddle_tpu_torch.fluid.ops import registry as treg
from paddle_tpu_torch.fluid.ops.grad_ops import ForwardRecord

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


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


def _pair(arrays, dtype):
    """{slot: numpy} as JAX and as torch inputs; float32 arrays in slots
    listed in `dtype` ({slot: dtype}) are rounded to it by each package."""
    def j(slot, a):
        a = jnp.asarray(a)
        return a.astype(jnp.bfloat16) if dtype.get(slot) == "bfloat16" \
            else a

    def t(slot, a):
        a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(torch.bfloat16) if dtype.get(slot) == "bfloat16" else a
    return ({k: [j(k, a)] for k, a in arrays.items()},
            {k: [t(k, a)] for k, a in arrays.items()})


def _close(got, want, rtol, scale=None):
    """max |got - want| within rtol of max |want| (or of ``scale``)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = scale if scale is not None else np.abs(want).max()
    err = np.abs(got - want).max() / (scale or 1.0)
    assert err <= rtol, err


def _randn(*shape, seed=0, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale + shift) \
        .astype(np.float32)


def _vjp(op, jin, tin, attrs, out_slot, wrt, dout):
    """(JAX outputs and input grads, port outputs and input grads) of op's
    `out_slot` under cotangent `dout` (numpy), w.r.t. the slots `wrt`."""
    def f(*vals):
        ins = dict(jin, **{s: [v] for s, v in zip(wrt, vals)})
        return jreg.get_lowering(op)(jreg.LoweringContext(), ins,
                                     attrs)[out_slot][0]
    jout, vjp = jax.vjp(f, *[jin[s][0] for s in wrt])
    jgrads = vjp(jnp.asarray(dout).astype(jout.dtype))
    leaves = {s: tin[s][0].detach().requires_grad_(True) for s in wrt}
    tout = treg.get_lowering(op)(treg.LoweringContext("cpu"),
                                 dict(tin, **{s: [v] for s, v in
                                              leaves.items()}),
                                 attrs)[out_slot][0]
    tgrads = torch.autograd.grad(
        tout, [leaves[s] for s in wrt],
        torch.from_numpy(dout).to(tout.dtype))
    return (jout, jgrads), (tout, tgrads)


# (input NCHW, filter OIHW, strides, paddings, dilations, groups)
CONV_CASES = {
    "1x1": ((2, 8, 6, 6), (16, 8, 1, 1), [1, 1], [0, 0], [1, 1], 1),
    "3x3_pad": ((2, 8, 7, 7), (8, 8, 3, 3), [1, 1], [1, 1], [1, 1], 1),
    "7x7_stride2": ((2, 3, 16, 16), (8, 3, 7, 7), [2, 2], [3, 3], [1, 1], 1),
    "1x1_stride2": ((2, 16, 7, 7), (32, 16, 1, 1), [2, 2], [0, 0], [1, 1],
                    1),
    "uneven": ((1, 4, 9, 8), (6, 4, 3, 2), [2, 1], [1, 0], [1, 1], 1),
    "dilated": ((2, 4, 9, 9), (4, 4, 3, 3), [1, 1], [2, 2], [2, 2], 1),
    "groups2": ((2, 8, 6, 6), (8, 4, 3, 3), [1, 1], [1, 1], [1, 1], 2),
    "groups32": ((2, 64, 6, 6), (64, 2, 3, 3), [2, 2], [1, 1], [1, 1], 32),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_and_its_grads_match_jax(case, dtype):
    xs, ws, strides, pads, dil, groups = CONV_CASES[case]
    x = _randn(*xs, seed=1)
    w = _randn(*ws, seed=2, scale=(2.0 / np.prod(ws[1:])) ** 0.5)
    attrs = {"strides": strides, "paddings": pads, "dilations": dil,
             "groups": groups}
    jin, tin = _pair({"Input": x, "Filter": w},
                     {"Input": dtype, "Filter": dtype})
    shape = jreg.get_lowering("conv2d")(jreg.LoweringContext(), jin,
                                        attrs)["Output"][0].shape
    dout = _randn(*shape, seed=3)
    (jout, jg), (tout, tg) = _vjp("conv2d", jin, tin, attrs, "Output",
                                  ["Input", "Filter"], dout)
    assert tout.dtype == tin["Input"][0].dtype
    _close(tout, jout, TOL[dtype])
    for got, want in zip(tg, jg):
        _close(got, want, TOL[dtype])


def test_f32_conv2d_runs_in_ieee_precision_and_restores_the_setting(
        monkeypatch):
    """A float32 conv2d's forward and backward run with cuDNN's conv
    precision at "ieee" (no TF32 on the card), and the caller's settings
    are back after each."""
    cudnn = torch.backends.cudnn
    seen = []
    conv, conv_bwd = torch.ops.aten.convolution, \
        torch.ops.aten.convolution_backward

    def spy_conv(*args, **kw):
        seen.append(("forward", cudnn.conv.fp32_precision))
        return conv(*args, **kw)

    def spy_bwd(*args, **kw):
        seen.append(("backward", cudnn.conv.fp32_precision))
        return conv_bwd(*args, **kw)
    monkeypatch.setattr(torch.ops.aten, "convolution", spy_conv)
    monkeypatch.setattr(torch.ops.aten, "convolution_backward", spy_bwd)
    before = (cudnn.conv.fp32_precision, cudnn.rnn.fp32_precision)
    x = torch.from_numpy(_randn(1, 2, 5, 5)).requires_grad_(True)
    w = torch.from_numpy(_randn(3, 2, 3, 3, seed=1)).requires_grad_(True)
    out = treg.get_lowering("conv2d")(
        treg.LoweringContext("cpu"), {"Input": [x], "Filter": [w]},
        {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
         "groups": 1})["Output"][0]
    assert (cudnn.conv.fp32_precision, cudnn.rnn.fp32_precision) == before
    out.sum().backward()
    assert (cudnn.conv.fp32_precision, cudnn.rnn.fp32_precision) == before
    assert seen == [("forward", "ieee"), ("backward", "ieee")]
    seen.clear()
    treg.get_lowering("conv2d")(
        treg.LoweringContext("cpu"),
        {"Input": [x.detach().bfloat16()], "Filter": [w.detach().bfloat16()]},
        {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
         "groups": 1})
    assert seen == [("forward", before[0])]


POOL_BASE = {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
             "paddings": [1, 1], "global_pooling": False, "ceil_mode": False,
             "exclusive": True}
POOL_CASES = {
    "max_resnet": ((2, 3, 9, 9), {}),
    "max_ceil": ((1, 2, 8, 8), {"ceil_mode": True, "paddings": [0, 0]}),
    "max_ceil_pad": ((1, 2, 10, 7), {"ceil_mode": True}),
    "max_2x2": ((2, 3, 8, 8), {"ksize": [2, 2], "paddings": [0, 0]}),
    "avg_exclusive": ((2, 3, 9, 9), {"pooling_type": "avg"}),
    "avg_inclusive": ((2, 3, 9, 9), {"pooling_type": "avg",
                                     "exclusive": False}),
    "avg_ceil_exclusive": ((1, 2, 10, 7), {"pooling_type": "avg",
                                           "ceil_mode": True}),
    "avg_ceil_inclusive": ((1, 2, 10, 7), {"pooling_type": "avg",
                                           "ceil_mode": True,
                                           "exclusive": False}),
    "avg_global": ((2, 4, 7, 7), {"pooling_type": "avg",
                                  "global_pooling": True, "ksize": [7, 7]}),
    "max_global": ((2, 4, 5, 6), {"global_pooling": True}),
    "avg_adaptive": ((2, 3, 8, 12), {"pooling_type": "avg", "adaptive": True,
                                     "ksize": [2, 3]}),
    "max_adaptive": ((2, 3, 8, 12), {"adaptive": True, "ksize": [4, 3]}),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool2d_and_its_grad_match_jax(case, dtype):
    shape, extra = POOL_CASES[case]
    attrs = dict(POOL_BASE, **extra)
    jin, tin = _pair({"X": _randn(*shape, seed=4)}, {"X": dtype})
    out_shape = jreg.get_lowering("pool2d")(jreg.LoweringContext(), jin,
                                            attrs)["Out"][0].shape
    dout = _randn(*out_shape, seed=5)
    (jout, (jg,)), (tout, (tg,)) = _vjp("pool2d", jin, tin, attrs, "Out",
                                        ["X"], dout)
    assert tout.dtype == tin["X"][0].dtype
    if attrs["pooling_type"] == "max":
        np.testing.assert_array_equal(_np(tout), _np(jout))
    else:
        _close(tout, jout, TOL[dtype])
    _close(tg, jg, TOL[dtype])


def _window_grads(x, attrs, out_shape, dout):
    """The max-pool gradient in numpy, window by window over x padded as
    the JAX lowering pads it: (to each window's first maximum in row-major
    order, shared evenly among its maxima)."""
    (k0, k1), (s0, s1), (p0, p1) = attrs["ksize"], attrs["strides"], \
        attrs["paddings"]
    oh, ow = out_shape[2:]
    extra_h = max((oh - 1) * s0 + k0 - (x.shape[2] + 2 * p0), 0)
    extra_w = max((ow - 1) * s1 + k1 - (x.shape[3] + 2 * p1), 0)
    xp = np.pad(x, ((0, 0), (0, 0), (p0, p0 + extra_h), (p1, p1 + extra_w)),
                constant_values=-np.inf)
    first, even = np.zeros_like(xp), np.zeros_like(xp)
    for n, c, i, j in np.ndindex(*out_shape):
        win = xp[n, c, i * s0:i * s0 + k0, j * s1:j * s1 + k1]
        at = np.argwhere(win == win.max())
        for r, (a, b) in enumerate(at):
            if r == 0:
                first[n, c, i * s0 + a, j * s1 + b] += dout[n, c, i, j]
            even[n, c, i * s0 + a, j * s1 + b] += dout[n, c, i, j] / len(at)
    crop = (slice(None), slice(None), slice(p0, p0 + x.shape[2]),
            slice(p1, p1 + x.shape[3]))
    return first[crop], even[crop]


@pytest.mark.parametrize("case", ["max_resnet", "max_ceil_pad", "max_2x2"])
def test_max_pool_gradient_of_tied_windows_goes_to_the_first_maximum(case):
    """Values drawn from {0, 1, 2} tie in most windows: each window's
    gradient must go to its first maximum in row-major order, where the
    JAX vjp (select_and_scatter_add with ge) sends it, bit for bit; the
    control, the gradient shared evenly among a window's maxima, differs."""
    shape, extra = POOL_CASES[case]
    attrs = dict(POOL_BASE, **extra)
    x = np.random.RandomState(6).randint(0, 3, shape).astype(np.float32)
    jin, tin = _pair({"X": x}, {})
    out_shape = jreg.get_lowering("pool2d")(jreg.LoweringContext(), jin,
                                            attrs)["Out"][0].shape
    dout = np.random.RandomState(7).randint(1, 5, out_shape).astype(
        np.float32)
    (_, (jg,)), (_, (tg,)) = _vjp("pool2d", jin, tin, attrs, "Out", ["X"],
                                  dout)
    first, even = _window_grads(x, attrs, out_shape, dout)
    np.testing.assert_array_equal(_np(jg), first)
    np.testing.assert_array_equal(_np(tg), first)
    assert not np.array_equal(even, first)


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_integer_max_pool_pads_with_the_integer_minimum(dtype):
    x = np.random.RandomState(8).randint(-9, 0, (1, 2, 5, 5)).astype(dtype)
    jin, tin = _pair({"X": x}, {})
    want = jreg.get_lowering("pool2d")(jreg.LoweringContext(), jin,
                                       POOL_BASE)["Out"][0]
    got = treg.get_lowering("pool2d")(treg.LoweringContext("cpu"), tin,
                                      POOL_BASE)["Out"][0]
    assert got.dtype == tin["X"][0].dtype
    np.testing.assert_array_equal(_np(got), _np(want))


BN_OUTS = ["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"]
# (X shape, layout); the channel axis holds 6
BN_CASES = {"nchw": ((4, 6, 5, 5), "NCHW"), "nhwc": ((4, 5, 5, 6), "NHWC"),
            "nchw_2x1x1": ((2, 6, 1, 1), "NCHW")}


def _bn_inputs(case, x_dtype):
    shape, layout = BN_CASES[case]
    arrays = {"X": _randn(*shape, seed=9, scale=2.0, shift=1.5),
              "Scale": _randn(6, seed=10, scale=0.3, shift=1.0),
              "Bias": _randn(6, seed=11),
              "Mean": _randn(6, seed=12, scale=0.2),
              "Variance": np.abs(_randn(6, seed=13)) + 0.5}
    return arrays, layout


def _bn_attrs(layout, mode):
    return {"momentum": 0.9, "epsilon": 1e-5, "data_layout": layout,
            "is_test": mode == "test",
            "use_global_stats": mode == "global_stats"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["train", "test", "global_stats"])
@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_norm_and_its_grad_match_jax(case, mode, dtype):
    arrays, layout = _bn_inputs(case, dtype)
    attrs = _bn_attrs(layout, mode)
    jin, tin = _pair(arrays, {"X": dtype})
    want = jreg.get_lowering("batch_norm")(jreg.LoweringContext(), jin,
                                           attrs)
    got = treg.get_lowering("batch_norm")(treg.LoweringContext("cpu"), tin,
                                          attrs)
    for slot in BN_OUTS:
        _close(got[slot][0], want[slot][0],
               TOL["float32"] if slot != "Y" else TOL[dtype])
        assert str(got[slot][0].dtype)[6:] == str(want[slot][0].dtype), slot
    # Y in X's dtype in training; from the running statistics it keeps the
    # f32 they promote it to, as in the JAX lowering
    assert got["Y"][0].dtype == (tin["X"][0].dtype if mode == "train"
                                 else torch.float32)
    dy = _randn(*want["Y"][0].shape, seed=14)
    jg_in, tg_in = _pair(dict(arrays, **{"Y@GRAD": dy}),
                         {"X": dtype, "Y@GRAD": dtype if mode == "train"
                          else "float32"})
    jgrad = jreg.get_lowering("batch_norm_grad")(jreg.LoweringContext(),
                                                 jg_in, attrs)
    tgrad = treg.get_lowering("batch_norm_grad")(treg.LoweringContext("cpu"),
                                                 tg_in, attrs)
    # dx sums terms of the size of dy * scale * rsqrt(var + eps), which
    # cancel (with two values a channel, to rounding noise): its error is
    # held relative to that size
    inv = _np(want["SavedVariance"][0])
    term = np.abs(_np(tg_in["Y@GRAD"][0])).max() * \
        np.abs(arrays["Scale"] * inv).max()
    for slot in ("X@GRAD", "Scale@GRAD", "Bias@GRAD"):
        _close(tgrad[slot][0], jgrad[slot][0],
               1e-4 if dtype == "float32" else TOL[dtype],
               scale=term if slot == "X@GRAD" else None)
    assert tgrad["X@GRAD"][0].dtype == tin["X"][0].dtype


def test_batch_norm_grad_from_its_forward_record_is_bit_for_bit():
    """The executor hands batch_norm_grad its forward op's SavedMean and
    SavedVariance: the grads equal those the op computes from X alone."""
    arrays, layout = _bn_inputs("nchw", "float32")
    attrs = _bn_attrs(layout, "train")
    _, tin = _pair(arrays, {})
    fwd = treg.get_lowering("batch_norm")(treg.LoweringContext("cpu"), tin,
                                          attrs)
    tin["Y@GRAD"] = [torch.from_numpy(_randn(4, 6, 5, 5, seed=15))]
    alone = treg.get_lowering("batch_norm_grad")(
        treg.LoweringContext("cpu"), tin, attrs)
    ctx = treg.LoweringContext("cpu")
    ctx.record = ForwardRecord([], fwd)
    paired = treg.get_lowering("batch_norm_grad")(ctx, tin, attrs)
    for slot in alone:
        assert torch.equal(alone[slot][0], paired[slot][0]), slot


def test_running_variance_is_biased_where_f_batch_norm_is_not():
    """Two values a channel: F.batch_norm blends in the unbiased variance
    (twice the biased one here), the JAX lowering and the port the biased
    one; SavedVariance is rsqrt(biased variance + eps), which F.batch_norm
    does not return."""
    arrays, layout = _bn_inputs("nchw_2x1x1", "float32")
    attrs = _bn_attrs(layout, "train")
    jin, tin = _pair(arrays, {})
    want = jreg.get_lowering("batch_norm")(jreg.LoweringContext(), jin,
                                           attrs)
    got = treg.get_lowering("batch_norm")(treg.LoweringContext("cpu"), tin,
                                          attrs)
    _close(got["VarianceOut"][0], want["VarianceOut"][0], TOL["float32"])
    x = torch.from_numpy(arrays["X"])
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    _close(got["SavedVariance"][0], torch.rsqrt(biased + 1e-5), 1e-6)
    mean = torch.from_numpy(arrays["Mean"]).clone()
    var = torch.from_numpy(arrays["Variance"]).clone()
    F.batch_norm(x, mean, var, torch.from_numpy(arrays["Scale"]),
                 torch.from_numpy(arrays["Bias"]), training=True,
                 momentum=0.1, eps=1e-5)
    _close(mean, want["MeanOut"][0], TOL["float32"])
    with pytest.raises(AssertionError):
        _close(var, want["VarianceOut"][0], TOL["float32"])


def _momentum_inputs(p_dtype, n=5, seed=16):
    rng = np.random.RandomState(seed)
    ins = []
    for k in range(n):
        shape = [(3, 4), (7,), (2, 3, 3), (5, 1), (6,)][k % 5]
        p = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        g = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        dtype = torch.bfloat16 if p_dtype == "bfloat16" and k % 2 == 0 \
            else torch.float32
        ins.append({"Param": [p.to(dtype)], "Grad": [g.to(dtype)],
                    "Velocity": [torch.from_numpy(
                        rng.randn(*shape).astype(np.float32))],
                    "LearningRate": [torch.tensor([0.01])]})
    return ins


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
def test_momentum_matches_jax(p_dtype, nesterov):
    attrs = {"mu": 0.9, "use_nesterov": nesterov}
    for ins in _momentum_inputs(p_dtype):
        jin = {k: [jnp.asarray(_np(v[0]).astype(np.float32)).astype(
            jnp.bfloat16 if v[0].dtype == torch.bfloat16 else jnp.float32)]
            for k, v in ins.items()}
        want = jreg.get_lowering("momentum")(jreg.LoweringContext(), jin,
                                             attrs)
        got = treg.get_lowering("momentum")(treg.LoweringContext("cpu"),
                                            ins, attrs)
        p_dtype_t = ins["Param"][0].dtype
        assert got["ParamOut"][0].dtype == p_dtype_t
        assert got["VelocityOut"][0].dtype == torch.float32
        _close(got["VelocityOut"][0], want["VelocityOut"][0], 1e-6)
        np.testing.assert_array_equal(_np(got["ParamOut"][0]),
                                      _np(want["ParamOut"][0]))


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
def test_momentum_group_is_the_op_by_op_lowering_bit_for_bit(p_dtype,
                                                             nesterov):
    """A run of momentum ops (f32 and bf16 parameters interleaved) through
    the group lowering: every ParamOut and VelocityOut equal to the op's own
    lowering, bit for bit."""
    attrs = {"mu": 0.9, "use_nesterov": nesterov}
    ins = _momentum_inputs(p_dtype, n=9)
    group = optimizer_ops._momentum_group(treg.LoweringContext("cpu"), ins,
                                          [attrs] * len(ins))
    for one_in, out in zip(ins, group):
        alone = optimizer_ops._momentum(treg.LoweringContext("cpu"), one_in,
                                        attrs)
        for slot in ("ParamOut", "VelocityOut"):
            assert out[slot][0].dtype == alone[slot][0].dtype
            assert torch.equal(out[slot][0], alone[slot][0]), slot


@pytest.mark.parametrize("k", [1, 3])
def test_top_k_orders_ties_lower_index_first(k):
    """Rows with repeated values (0, 1, 2 over 12 columns): values and
    indices equal the JAX lowering's, ties lower index first, int64."""
    x = np.random.RandomState(17).randint(0, 3, (6, 12)).astype(np.float32)
    jin, tin = _pair({"X": x}, {})
    want = jreg.get_lowering("top_k")(jreg.LoweringContext(), jin, {"k": k})
    got = treg.get_lowering("top_k")(treg.LoweringContext("cpu"), tin,
                                     {"k": k})
    assert got["Indices"][0].dtype == torch.int64
    np.testing.assert_array_equal(_np(got["Out"][0]), _np(want["Out"][0]))
    np.testing.assert_array_equal(_np(got["Indices"][0]),
                                  _np(want["Indices"][0]))
    first = np.argsort(-x, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(_np(got["Indices"][0]), first)


@pytest.mark.parametrize("k", [1, 2])
def test_accuracy_matches_jax_with_its_dtypes(k):
    """Accuracy a float32 scalar, Correct and Total int32 scalars."""
    rng = np.random.RandomState(18)
    x = rng.randn(8, 5).astype(np.float32)
    label = rng.randint(0, 5, (8, 1)).astype(np.int64)
    jtop = jreg.get_lowering("top_k")(
        jreg.LoweringContext(), {"X": [jnp.asarray(x)]}, {"k": k})
    ttop = treg.get_lowering("top_k")(
        treg.LoweringContext("cpu"), {"X": [torch.from_numpy(x)]}, {"k": k})
    want = jreg.get_lowering("accuracy")(
        jreg.LoweringContext(), {"Out": jtop["Out"],
                                 "Indices": jtop["Indices"],
                                 "Label": [jnp.asarray(label)]}, {})
    got = treg.get_lowering("accuracy")(
        treg.LoweringContext("cpu"), {"Out": ttop["Out"],
                                      "Indices": ttop["Indices"],
                                      "Label": [tensor_from_numpy(label)]},
        {})
    dtypes = {"Accuracy": torch.float32, "Correct": torch.int32,
              "Total": torch.int32}
    for slot, dtype in dtypes.items():
        t = got[slot][0]
        assert t.dtype == dtype and t.shape == (), slot
        np.testing.assert_array_equal(_np(t), _np(want[slot][0]))
    hits = (np.argsort(-x, axis=1, kind="stable")[:, :k] == label).any(1)
    assert int(got["Correct"][0]) == hits.sum()
    assert float(got["Accuracy"][0]) == np.float32(hits.sum()) / 8
