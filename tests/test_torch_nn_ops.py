"""The rest of the NN lowerings (``paddle_tpu_torch/fluid/ops/nn_ops.py``:
conv2d_transpose, conv3d, pool3d, group_norm, data_norm, affine_channel,
lrn, bilinear_interp, nearest_interp, grid_sampler, im2sequence,
bilinear_tensor_product, row_conv, conv_shift; and all of
``misc_nn_ops.py``), each against the JAX package's lowering of the same
op on the same seeded inputs, on the CPU.

Tolerance: float32 outputs within 1e-5 of the largest JAX magnitude, the
convolutions within 1e-4; similarity_focus's masks exactly. Gradients:
``jax.vjp`` of the JAX lowering (one jitted function) against autograd
through the port's lowering, at the same bounds. bfloat16: each output in
the JAX lowering's dtype, within one bfloat16 ulp of the value plus 2^-8
of the largest, against the JAX lowering run in float32 on the same
bfloat16-rounded inputs (the JAX lowering rounds each op of its formula
to bfloat16 on the CPU; the port computes in float32 and rounds once).

The random ops (sample_logits, sampled softmax's own draws) are held by
invariants: the samples in range, the first columns the labels, q by its
formula, accidental hits at -1e20, the draws' distribution (chi-square).
Besides, each difference from the Paddle reference that the port mirrors
(ROADMAP Queue 3) is pinned here on both sides, and each trap: the
antialiasing shrink, nearest-exact, grid_sampler past the border,
adaptive_pool3d's stride-1 window, transposed convolutions at groups 1, 2
and 4, max pooling padded past half the window.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from paddle_tpu.fluid.ops import registry as jreg
from paddle_tpu_torch.fluid.ops import registry as treg
from paddle_tpu_torch.fluid.ops import misc_nn_ops, tensor_ops

F32_TOL, CONV_TOL = 1e-5, 1e-4
BF16_ULP, BF16_FLOOR = 2.0 ** -8, 2.0 ** -8


def _rng(seed):
    return np.random.RandomState(seed)


def _randn(*shape, seed=0):
    return _rng(seed).randn(*shape).astype(np.float32)


def _uniform(lo, hi, *shape, seed=0):
    return _rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        x = x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    if x.dtype.kind in "iu":
        return x.astype(np.int64)
    return x.astype(np.float64)


def _bf16_round(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _inputs(arrays, bf16=False, jax_f32=False):
    """(JAX inputs, port inputs); bf16 rounds every float32 array to
    bfloat16 (jax_f32: the JAX side gets the rounded values in float32)."""
    def j(a):
        a = jnp.asarray(a)
        if bf16 and a.dtype == jnp.float32:
            a = a.astype(jnp.bfloat16)
            return a.astype(jnp.float32) if jax_f32 else a
        return a

    def t(a):
        a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(torch.bfloat16) if bf16 and a.dtype == torch.float32 \
            else a
    return ({k: [j(a) for a in v] for k, v in arrays.items()},
            {k: [t(a) for a in v] for k, v in arrays.items()})


def _check(got, want, tol, err_msg=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    if want.dtype.kind == "i" or tol == 0.0:
        np.testing.assert_array_equal(got, want, err_msg=err_msg)
        return
    bound = tol * np.abs(want).max()
    assert np.abs(got - want).max() <= bound, (err_msg, np.abs(
        got - want).max(), bound)


def _check_bf16(got, want, err_msg=""):
    """Within one bfloat16 ulp of the value plus 2^-8 of the largest."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    if want.dtype.kind == "i":
        np.testing.assert_array_equal(got, want, err_msg=err_msg)
        return
    bound = BF16_ULP * np.abs(want) + BF16_FLOOR * np.abs(want).max()
    assert (np.abs(got - want) <= bound).all(), (
        err_msg, np.abs(got - want).max())


def _tree_edges():
    """Two trees of 6 nodes as EdgeSet [2, 5, 2] (parent, child): the first
    a full tree of 5 edges, the second 3 edges then two padding rows
    (parent == child)."""
    return np.array([[[0, 1], [0, 2], [1, 3], [1, 4], [2, 5]],
                     [[0, 1], [1, 2], [1, 3], [0, 0], [0, 0]]], np.int32)


def _custom_tree():
    """A PathTable / PathCode for 4 classes over 4 nodes (one class's path
    one node long, the others padded with -1)."""
    ptab = np.array([[0, 1, -1], [0, 1, 3], [0, 2, -1], [2, -1, -1]],
                    np.int64)
    pcode = np.array([[0, 1, 0], [1, 0, 1], [1, 1, 0], [0, 0, 0]],
                     np.int64)
    return ptab, pcode


def _customized_samples():
    """4 rows, 1 label, 5 drawn classes of 10 (the label among them in rows
    0 and 2: accidental hits), and their probabilities."""
    labels = np.array([[3], [0], [9], [5]], np.int64)
    drawn = np.array([[1, 3, 4, 3, 8], [2, 2, 7, 1, 6], [9, 0, 5, 9, 4],
                      [6, 2, 8, 0, 1]], np.int64)
    probs = _uniform(0.05, 0.3, 4, 6, seed=7)
    return labels, np.concatenate([labels, drawn], 1), probs


LABELS, SAMPLES, PROBS = _customized_samples()
PTAB, PCODE = _custom_tree()

# case -> (inputs, attrs, the differentiable output slot). The op is the
# case's name up to "__".
CASES = {
    # transposed convolutions: groups 1, 2 and 4, stride, dilation, a
    # padding past k - 1 (the JAX package crops)
    "conv2d_transpose": ({"Input": [_randn(2, 4, 5, 5)],
                          "Filter": [_randn(4, 3, 3, 3, seed=1)]},
                         {"strides": [2, 2], "paddings": [1, 1],
                          "dilations": [1, 1], "groups": 1}, "Output"),
    "conv2d_transpose__groups2": ({"Input": [_randn(2, 4, 5, 5)],
                                   "Filter": [_randn(4, 2, 3, 3, seed=1)]},
                                  {"strides": [2, 1], "paddings": [0, 2],
                                   "dilations": [1, 2], "groups": 2},
                                  "Output"),
    "conv2d_transpose__groups4": ({"Input": [_randn(2, 4, 5, 6)],
                                   "Filter": [_randn(4, 2, 4, 4, seed=1)]},
                                  {"strides": [2, 2], "paddings": [1, 1],
                                   "groups": 4}, "Output"),
    "conv2d_transpose__crop": ({"Input": [_randn(2, 3, 5, 5)],
                                "Filter": [_randn(3, 2, 3, 3, seed=1)]},
                               {"strides": [2, 2], "paddings": [3, 3]},
                               "Output"),
    "conv2d_transpose__1x1_to_4x4": ({"Input": [_randn(2, 6, 1, 1)],
                                      "Filter": [_randn(6, 4, 4, 4, seed=1)]},
                                     {"strides": [1, 1], "paddings": [0, 0]},
                                     "Output"),
    "conv3d": ({"Input": [_randn(2, 3, 4, 5, 5)],
                "Filter": [_randn(4, 3, 3, 3, 3, seed=1)]},
               {"strides": [1, 2, 2], "paddings": [1, 1, 1],
                "dilations": [1, 1, 1], "groups": 1}, "Output"),
    "conv3d__groups3": ({"Input": [_randn(2, 3, 4, 5, 5)],
                         "Filter": [_randn(6, 1, 2, 3, 3, seed=1)]},
                        {"strides": [1, 1, 1], "paddings": [0, 1, 0],
                         "dilations": [2, 1, 1], "groups": 3}, "Output"),
    "conv3d_transpose": ({"Input": [_randn(2, 4, 3, 4, 4)],
                          "Filter": [_randn(4, 3, 2, 2, 2, seed=1)]},
                         {"strides": [2, 2, 2], "paddings": [0, 0, 0],
                          "dilations": [1, 1, 1], "groups": 1}, "Output"),
    "conv3d_transpose__groups2": ({"Input": [_randn(2, 4, 3, 4, 4)],
                                   "Filter": [_randn(4, 3, 3, 3, 3, seed=1)]},
                                  {"strides": [1, 2, 2], "paddings": [1, 1, 1],
                                   "groups": 2}, "Output"),
    "depthwise_conv2d_transpose": ({"Input": [_randn(2, 4, 5, 5)],
                                    "Filter": [_randn(4, 1, 3, 3, seed=1)]},
                                   {"strides": [2, 2], "paddings": [1, 1],
                                    "groups": 4}, "Output"),
    # groups 0 takes the channels
    "depthwise_conv2d_transpose__groups0": (
        {"Input": [_randn(2, 4, 5, 5)], "Filter": [_randn(4, 2, 3, 3,
                                                          seed=1)]},
        {"strides": [1, 1], "paddings": [1, 1], "groups": 0}, "Output"),
    # no groups attr: 1 stays 1
    "depthwise_conv2d_transpose__no_groups": (
        {"Input": [_randn(2, 4, 5, 5)], "Filter": [_randn(4, 3, 3, 3,
                                                          seed=1)]},
        {"strides": [2, 2]}, "Output"),
    # pooling
    "pool3d": ({"X": [_randn(2, 3, 4, 6, 6)]},
               {"pooling_type": "max", "ksize": [1, 2, 2],
                "strides": [1, 2, 2], "paddings": [0, 0, 0]}, "Out"),
    # padding over half the window (F.max_pool3d refuses it)
    "pool3d__max_wide_pad": ({"X": [_randn(2, 2, 4, 5, 5)]},
                             {"pooling_type": "max", "ksize": [3, 3, 3],
                              "strides": [2, 2, 2], "paddings": [2, 2, 2]},
                             "Out"),
    "pool3d__avg": ({"X": [_randn(2, 3, 4, 6, 6)]},
                    {"pooling_type": "avg", "ksize": [2, 2, 2],
                     "strides": [2, 2, 2]}, "Out"),
    # average divides by the window even over padding; exclusive not read
    "pool3d__avg_padded": ({"X": [_randn(2, 3, 4, 5, 5)]},
                           {"pooling_type": "avg", "ksize": [3, 3, 3],
                            "strides": [1, 2, 2], "paddings": [1, 1, 1],
                            "exclusive": True}, "Out"),
    "pool3d__global": ({"X": [_randn(2, 3, 4, 5, 5)]},
                       {"pooling_type": "avg", "ksize": [1, 1, 1],
                        "global_pooling": True}, "Out"),
    # adaptive not read: a 2^3 window at stride 1
    "pool3d__adaptive": ({"X": [_randn(2, 3, 4, 4, 4)]},
                         {"pooling_type": "avg", "ksize": [2, 2, 2],
                          "adaptive": True}, "Out"),
    # normalisations
    "group_norm": ({"X": [_randn(2, 6, 4, 5) * 3 + 1],
                    "Scale": [_randn(6, seed=1)],
                    "Bias": [_randn(6, seed=2)]},
                   {"epsilon": 1e-5, "groups": 3}, "Y"),
    "group_norm__no_affine": ({"X": [_randn(3, 8, 3, 3)]},
                              {"epsilon": 1e-4, "groups": 2}, "Y"),
    "data_norm": ({"X": [_randn(6, 4)],
                   "BatchSize": [_uniform(50, 100, 4, seed=1)],
                   "BatchSum": [_randn(4, seed=2) * 10],
                   "BatchSquareSum": [_uniform(50, 200, 4, seed=3)]},
                  {"epsilon": 1e-5}, "Y"),
    "affine_channel": ({"X": [_randn(2, 3, 4, 5)],
                        "Scale": [_randn(3, seed=1)],
                        "Bias": [_randn(3, seed=2)]},
                       {"data_layout": "NCHW"}, "Out"),
    "affine_channel__nhwc": ({"X": [_randn(2, 4, 5, 3)],
                              "Scale": [_randn(3, seed=1)],
                              "Bias": [_randn(3, seed=2)]},
                             {"data_layout": "NHWC"}, "Out"),
    "lrn": ({"X": [_randn(2, 7, 3, 4)]},
            {"n": 5, "k": 2.0, "alpha": 1e-2, "beta": 0.75}, "Out"),
    "lrn__alexnet": ({"X": [_randn(2, 6, 3, 3) * 20]},
                     {"n": 5, "k": 2.0, "alpha": 1e-4, "beta": 0.75},
                     "Out"),
    "lrn__n3": ({"X": [_randn(2, 4, 3, 3)]},
                {"n": 3, "k": 1.0, "alpha": 0.5, "beta": 0.5}, "Out"),
    # resizing: shrinks (antialiased), mixed, grows
    "bilinear_interp": ({"X": [_randn(2, 3, 16, 12)]},
                        {"out_h": 8, "out_w": 6}, "Out"),
    "bilinear_interp__7x5": ({"X": [_randn(2, 3, 16, 12)]},
                             {"out_h": 7, "out_w": 5}, "Out"),
    "bilinear_interp__20x9": ({"X": [_randn(2, 3, 16, 12)]},
                              {"out_h": 20, "out_w": 9}, "Out"),
    "bilinear_interp__grow": ({"X": [_randn(2, 3, 6, 5)]},
                              {"out_h": 12, "out_w": 11}, "Out"),
    "nearest_interp": ({"X": [_randn(2, 3, 16, 12)]},
                       {"out_h": 8, "out_w": 6}, "Out"),
    "nearest_interp__7x5": ({"X": [_randn(2, 3, 16, 12)]},
                            {"out_h": 7, "out_w": 5}, "Out"),
    "nearest_interp__grow": ({"X": [_randn(2, 3, 6, 5)]},
                             {"out_h": 12, "out_w": 13}, "Out"),
    # sampling, the grid past the border
    "grid_sampler": ({"X": [_randn(2, 3, 5, 6)],
                      "Grid": [_uniform(-1.3, 1.3, 2, 4, 7, 2, seed=1)]},
                     {}, "Output"),
    "grid_sampler__inside": ({"X": [_randn(2, 2, 6, 6)],
                              "Grid": [_uniform(-0.9, 0.9, 2, 5, 5, 2,
                                                seed=1)]}, {}, "Output"),
    "affine_grid": ({"Theta": [_randn(2, 2, 3)]},
                    {"output_shape": [2, 1, 5, 7]}, "Output"),
    # the sequence-shaped and pairwise ops
    "im2sequence": ({"X": [_randn(2, 3, 6, 7)]},
                    {"kernels": [3, 2], "strides": [1, 2],
                     "paddings": [1, 0, 2, 1]}, "Out"),
    "im2sequence__column": ({"X": [_randn(2, 4, 6, 10)]},
                            {"kernels": [6, 1], "strides": [1, 1],
                             "paddings": [0, 0, 0, 0]}, "Out"),
    "bilinear_tensor_product": ({"X": [_randn(5, 4)], "Y": [_randn(5, 3,
                                                               seed=1)],
                                 "Weight": [_randn(6, 4, 3, seed=2)],
                                 "Bias": [_randn(1, 6, seed=3)]}, {}, "Out"),
    "bilinear_tensor_product__no_bias": (
        {"X": [_randn(5, 4)], "Y": [_randn(5, 4, seed=1)],
         "Weight": [_randn(2, 4, 4, seed=2)]}, {}, "Out"),
    "row_conv": ({"X": [_randn(2, 7, 5)], "Filter": [_randn(3, 5, seed=1)]},
                 {}, "Out"),
    "conv_shift": ({"X": [_randn(4, 9)], "Y": [_randn(4, 3, seed=1)]}, {},
                   "Out"),
    "conv_shift__5": ({"X": [_randn(3, 6)], "Y": [_randn(3, 5, seed=1)]},
                      {}, "Out"),
    "fsp": ({"X": [_randn(2, 3, 4, 5)], "Y": [_randn(2, 5, 4, 5, seed=1)]},
            {}, "Out"),
    "tree_conv": ({"NodesVector": [_randn(2, 6, 4)],
                   "EdgeSet": [_tree_edges()],
                   "Filter": [_randn(4, 3, 5, 2, seed=1)]},
                  {"max_depth": 2}, "Out"),
    "similarity_focus": ({"X": [_randn(2, 3, 4, 5)]},
                         {"axis": 1, "indexes": [0, 2]}, "Out"),
    "similarity_focus__axis2": ({"X": [_randn(2, 4, 3, 5)]},
                                {"axis": 2, "indexes": [1]}, "Out"),
    "spectral_norm": ({"Weight": [_randn(6, 4, 3)], "U": [_randn(6, seed=1)],
                       "V": [_randn(12, seed=2)]},
                      {"dim": 0, "power_iters": 2, "eps": 1e-12}, "Out"),
    "spectral_norm__dim1": ({"Weight": [_randn(4, 6, 3)],
                             "U": [_randn(6, seed=1)],
                             "V": [_randn(12, seed=2)]},
                            {"dim": 1, "power_iters": 1, "eps": 1e-12},
                            "Out"),
    "spectral_norm__no_iterations": ({"Weight": [_randn(5, 4)],
                                      "U": [_randn(5, seed=1)],
                                      "V": [_randn(4, seed=2)]},
                                     {"dim": 0, "power_iters": 0}, "Out"),
    "hierarchical_sigmoid": ({"X": [_randn(5, 4)],
                              "W": [_randn(6, 4, seed=1)],
                              "Label": [np.array([[0], [6], [3], [5], [3]],
                                                 np.int64)],
                              "Bias": [_randn(6, 1, seed=2)]},
                             {"num_classes": 7}, "Out"),
    "hierarchical_sigmoid__pow2": ({"X": [_randn(6, 3)],
                                    "W": [_randn(7, 3, seed=1)],
                                    "Label": [np.array([[0], [7], [1], [4],
                                                        [4], [2]],
                                                       np.int64)],
                                    "Bias": [_randn(7, 1, seed=2)]},
                                   {"num_classes": 8}, "Out"),
    "hierarchical_sigmoid__custom": ({"X": [_randn(5, 3)],
                                      "W": [_randn(4, 3, seed=1)],
                                      "Label": [np.array([[0], [1], [2], [3],
                                                          [1]], np.int64)],
                                      "Bias": [_randn(4, 1, seed=2)],
                                      "PathTable": [PTAB],
                                      "PathCode": [PCODE]},
                                     {"num_classes": 4, "is_custom": True},
                                     "Out"),
    "sampled_softmax_with_cross_entropy__customized": (
        {"Logits": [_randn(4, 10)], "Labels": [LABELS],
         "CustomizedSamples": [SAMPLES],
         "CustomizedProbabilities": [PROBS]},
        {"num_samples": 5, "num_true": 1, "use_customized_samples": True,
         "remove_accidental_hits": True}, "Loss"),
    "sampled_softmax_with_cross_entropy__customized_keep_hits": (
        {"Logits": [_randn(4, 10)], "Labels": [LABELS],
         "CustomizedSamples": [SAMPLES],
         "CustomizedProbabilities": [PROBS]},
        {"num_samples": 5, "num_true": 1, "use_customized_samples": True,
         "remove_accidental_hits": False}, "Loss"),
}

# the 24 lowerings of the slice
SLICE = ["conv2d_transpose", "conv3d", "pool3d", "group_norm", "data_norm",
         "affine_channel", "lrn", "bilinear_interp", "nearest_interp",
         "grid_sampler", "im2sequence", "bilinear_tensor_product",
         "row_conv", "conv_shift", "conv3d_transpose",
         "depthwise_conv2d_transpose", "spectral_norm", "affine_grid",
         "fsp", "similarity_focus", "hierarchical_sigmoid", "sample_logits",
         "tree_conv", "sampled_softmax_with_cross_entropy"]
CONVS = ("conv2d_transpose", "conv3d", "conv3d_transpose",
         "depthwise_conv2d_transpose")
EXACT = ("similarity_focus", "pool3d", "nearest_interp", "im2sequence",
         "affine_channel__nhwc")
GRAD_CASES = sorted(c for c in CASES
                    if not c.startswith(("similarity_focus",
                                         "spectral_norm")))


def _op(case):
    return case.split("__")[0]


def _tol(case):
    if case.startswith("pool3d") and "avg" not in case and \
            "global" not in case and "adaptive" not in case:
        return 0.0
    if case.startswith(("similarity_focus", "nearest_interp",
                        "im2sequence")):
        return 0.0
    return CONV_TOL if case.startswith(CONVS) else F32_TOL


def _run(op, arrays, attrs, **kw):
    jin, tin = _inputs(arrays, **kw)
    want = jreg.get_lowering(op)(jreg.LoweringContext(), jin, attrs)
    got = treg.get_lowering(op)(treg.LoweringContext("cpu"), tin, attrs)
    return want, got


def _lower(op, inputs, attrs, gen=None):
    return treg.get_lowering(op)(treg.LoweringContext("cpu", gen), inputs,
                                 attrs)


def test_the_cases_cover_the_slice():
    """Each of the 24 lowerings has a case here or a random-op test, in
    both packages; the port holds 297 (203 after this slice, 14 more with
    the control-flow slice: tests/test_torch_array_ops.py, 15 more with
    the sequence slice: tests/test_torch_sequence_ops.py, 8 more with the
    recurrent slice: tests/test_torch_rnn_ops.py, 6 more with the decoding
    slice: tests/test_torch_decode_ops.py, 9 more with the CTC and
    index-pooling slice: tests/test_torch_ctc_pool_ops.py, 23 more with
    the detection slice: tests/test_torch_detection_ops.py, 19 more with
    the compression slice: tests/test_torch_quantize_ops.py and
    test_torch_parity_ops.py), and the JAX package's 20 others are what ROADMAP.md lists as still to port: of
    nn_ops.py's only switch_moe, sync_batch_norm and sync_batch_norm_grad,
    of misc_nn_ops.py none."""
    assert {_op(c) for c in CASES} | {"sample_logits"} == set(SLICE)
    assert len(SLICE) == 24
    assert all(treg.has_lowering(op) and jreg.has_lowering(op)
               for op in SLICE)
    assert len(treg._LOWERINGS) == 297
    assert set(treg._LOWERINGS) <= set(jreg._LOWERINGS)
    missing = set(jreg._LOWERINGS) - set(treg._LOWERINGS)
    assert len(missing) == 20

    def module(op):
        return jreg._LOWERINGS[op].__module__.rsplit(".", 1)[-1]
    assert {op for op in missing if module(op) == "nn_ops"} == \
        {"switch_moe", "sync_batch_norm", "sync_batch_norm_grad"}
    assert not {op for op in missing if module(op) == "misc_nn_ops"}
    assert {op for op in SLICE if jreg.is_no_grad(op)} == \
        {op for op in SLICE if treg.is_no_grad(op)} == {"similarity_focus"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    arrays, attrs, _ = CASES[case]
    want, got = _run(_op(case), arrays, attrs)
    assert set(got) == set(want), (sorted(got), sorted(want))
    for slot in want:
        assert len(got[slot]) == len(want[slot]), slot
        for i, (g, w) in enumerate(zip(got[slot], want[slot])):
            _check(g, w, _tol(case), err_msg="%s[%d]" % (slot, i))


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_forward_matches_jax(case):
    """bfloat16 inputs: each output in the JAX lowering's dtype (the JAX
    package's int32 where the port's is int64), within one bf16 ulp plus
    2^-8 of the JAX lowering's float32 values on the same rounded
    inputs."""
    arrays, attrs, _ = CASES[case]
    jin, tin = _inputs(arrays, bf16=True)
    want_dtype = jreg.get_lowering(_op(case))(jreg.LoweringContext(), jin,
                                              attrs)
    got = treg.get_lowering(_op(case))(treg.LoweringContext("cpu"), tin,
                                       attrs)
    jin32, _ = _inputs(arrays, bf16=True, jax_f32=True)
    want = jreg.get_lowering(_op(case))(jreg.LoweringContext(), jin32, attrs)
    for slot in want:
        for i, (g, w) in enumerate(zip(got[slot], want[slot])):
            wd = str(want_dtype[slot][i].dtype)
            assert _dtype_name(g) == wd or (
                wd == "int32" and g.dtype == torch.int64), (slot, g.dtype, wd)
            if g.dtype == torch.bfloat16:
                w = _bf16_round(w)
            _check_bf16(g, w, err_msg="%s[%d]" % (slot, i))


def _float_keys(arrays):
    return [(k, i) for k, v in arrays.items() for i, a in enumerate(v)
            if a.dtype == np.float32]


def _cots(outs):
    return [_rng(9 + i).randn(*o.shape).astype(np.float32)
            for i, o in enumerate(outs)]


@pytest.fixture(scope="module")
def jax_vjps():
    """{case: (cotangents, the JAX gradients)} in one jitted function."""
    fns, args, cots = [], [], []
    for case in GRAD_CASES:
        arrays, attrs, slot = CASES[case]
        jin, _ = _inputs(arrays)
        keys = _float_keys(arrays)

        def fn(*xs, jin=jin, keys=keys, attrs=attrs, case=case, slot=slot):
            ins = {k: list(v) for k, v in jin.items()}
            for (k, i), x in zip(keys, xs):
                ins[k][i] = x
            return tuple(jreg.get_lowering(_op(case))(
                jreg.LoweringContext(), ins, attrs)[slot])
        xs = [jin[k][i] for k, i in keys]
        fns.append(fn)
        args.append(xs)
        cots.append(_cots(jax.eval_shape(fn, *xs)))

    @jax.jit
    def all_vjps(args, cots):
        return [jax.vjp(fn, *xs)[1](tuple(cs))
                for fn, xs, cs in zip(fns, args, cots)]
    grads = all_vjps(args, [[jnp.asarray(c) for c in cs] for cs in cots])
    return {c: (cs, g) for c, cs, g in zip(GRAD_CASES, cots, grads)}


def _port_grads(case, cots):
    arrays, attrs, slot = CASES[case]
    _, tin = _inputs(arrays)
    leaves = []
    for k, i in _float_keys(arrays):
        tin[k][i] = tin[k][i].clone().requires_grad_(True)
        leaves.append(tin[k][i])
    outs = treg.get_lowering(_op(case))(treg.LoweringContext("cpu"), tin,
                                        attrs)[slot]
    got = torch.autograd.grad(outs, leaves, [torch.from_numpy(c)
                                             for c in cots],
                              allow_unused=True)
    return [torch.zeros_like(leaf) if g is None else g
            for leaf, g in zip(leaves, got)]


@pytest.mark.parametrize("case", GRAD_CASES)
def test_gradient_matches_jax_vjp(case, jax_vjps):
    cots, want = jax_vjps[case]
    got = _port_grads(case, cots)
    assert len(got) == len(want)
    tol = CONV_TOL if case.startswith(CONVS) else F32_TOL
    for key, g, w in zip(_float_keys(CASES[case][0]), got, want):
        w = np.asarray(w)
        if not np.abs(w).max():
            # a gradient the JAX lowering stops (U and V, the path codes)
            assert not bool(g.abs().max()), key
            continue
        _check(g, w, tol, err_msg="%s[%d]" % key)


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if c.startswith("spectral_norm")))
def test_spectral_norm_gradient_is_the_jax_executors(case):
    """The JAX executor's grad op re-runs spectral_norm from U and V after
    the forward op wrote UOut and VOut into them: its Weight gradient is
    jax.vjp of the lowering at (Weight, UOut, VOut), power_iters more
    steps of iteration; the port's is that, and no gradient reaches U or
    V. (At the forward's own U and V the vjp differs unless power_iters is
    0.)"""
    arrays, attrs, _ = CASES[case]
    jin, tin = _inputs(arrays)
    lower = jreg.get_lowering("spectral_norm")
    fwd = lower(jreg.LoweringContext(), jin, attrs)
    cot = _randn(*arrays["Weight"][0].shape, seed=9)

    def weight_grad(u, v):
        def f(w):
            return lower(jreg.LoweringContext(), {"Weight": [w], "U": [u],
                                                  "V": [v]}, attrs)["Out"][0]
        return np.asarray(jax.vjp(f, jin["Weight"][0])[1](
            jnp.asarray(cot))[0])
    want = weight_grad(fwd["UOut"][0], fwd["VOut"][0])
    leaves = [tin[k][0].requires_grad_(True) for k in ("Weight", "U", "V")]
    out, = treg.get_lowering("spectral_norm")(
        treg.LoweringContext("cpu"), tin, attrs)["Out"]
    dw, du, dv = torch.autograd.grad(out, leaves, torch.from_numpy(cot),
                                     allow_unused=True)
    _check(dw, want, F32_TOL)
    assert du is None and dv is None
    at_forward = weight_grad(jin["U"][0], jin["V"][0])
    differs = np.abs(at_forward - want).max() > 1e-3 * np.abs(want).max()
    assert differs == (attrs["power_iters"] > 0)


# --------------------------------------------------------------------------
# the differences from the Paddle reference (ROADMAP Queue 3), both sides
# --------------------------------------------------------------------------

def _both(op, arrays, attrs):
    want, got = _run(op, arrays, attrs)
    slot = next(iter(want))
    return _np(want[slot][0]), _np(got[slot][0])


@pytest.mark.parametrize("size", [(8, 6), (7, 5), (20, 9)])
def test_shrinking_resize_antialiases_in_both_packages(size):
    """bilinear_interp shrinking [2, 3, 16, 12] equals F.interpolate with
    antialias=True (half-pixel centres) in both packages; without
    antialiasing it misses by far more than the bound."""
    x = _randn(2, 3, 16, 12)
    attrs = {"out_h": size[0], "out_w": size[1]}
    want, got = _both("bilinear_interp", {"X": [x]}, attrs)
    aa = F.interpolate(torch.from_numpy(x), size, mode="bilinear",
                       align_corners=False, antialias=True).numpy()
    plain = F.interpolate(torch.from_numpy(x), size, mode="bilinear",
                          align_corners=False).numpy()
    for out in (want, got):
        assert np.abs(out - aa).max() <= F32_TOL * np.abs(aa).max()
        assert np.abs(out - plain).max() > 0.3


def test_nearest_resize_is_nearest_exact_not_nearest():
    x = _randn(2, 3, 16, 12)
    want, got = _both("nearest_interp", {"X": [x]}, {"out_h": 7,
                                                     "out_w": 5})
    exact = F.interpolate(torch.from_numpy(x), (7, 5),
                          mode="nearest-exact").numpy()
    legacy = F.interpolate(torch.from_numpy(x), (7, 5),
                           mode="nearest").numpy()
    np.testing.assert_array_equal(want, exact)
    np.testing.assert_array_equal(got, exact)
    assert np.abs(got - legacy).max() > 1.0


def test_resize_ignores_align_corners_in_both_packages():
    """resize_bilinear of arange(4) to 8 (align_corners=True by default in
    the layer) gives half-pixel centres, [0, .25, .75, 1.25, ...], where
    align_corners would give [0, 3/7, 6/7, ...]."""
    x = np.arange(4, dtype=np.float32).reshape(1, 1, 1, 4)
    want, got = _both("bilinear_interp", {"X": [x]}, {"out_h": 1,
                                                      "out_w": 8})
    half = np.array([0, .25, .75, 1.25, 1.75, 2.25, 2.75, 3.0])
    np.testing.assert_allclose(want.reshape(-1), half, atol=1e-6)
    np.testing.assert_allclose(got.reshape(-1), half, atol=1e-6)


def test_grid_sampler_pads_with_the_border_in_both_packages():
    """Past the image the sample is the border's value (Paddle's reference
    pads with zeros); zero padding misses."""
    x = _randn(1, 2, 4, 5)
    grid = np.array([[[[-1.5, 0.0], [1.7, 1.2], [0.2, -2.0]]]], np.float32)
    want, got = _both("grid_sampler", {"X": [x], "Grid": [grid]}, {})
    t = torch.from_numpy
    border = F.grid_sample(t(x), t(grid), padding_mode="border",
                           align_corners=True).numpy()
    zeros = F.grid_sample(t(x), t(grid), padding_mode="zeros",
                          align_corners=True).numpy()
    for out in (want, got):
        np.testing.assert_allclose(out, border, atol=1e-6)
        assert np.abs(out - zeros).max() > 0.1
    # (-1.5, 0): column 0 of the middle row, interpolated between rows 1, 2
    np.testing.assert_allclose(got[0, :, 0, 0], x[0, :, 1:3, 0].mean(1),
                               atol=1e-6)


def test_adaptive_pool3d_pools_by_a_stride_one_window_in_both_packages():
    """pool3d with adaptive=True (adaptive_pool3d's op) over 4^3 with
    pool_size 2 gives 3^3: the 2^3 window at stride 1, not the 2^3 output
    of adaptive pooling."""
    x = _randn(1, 2, 4, 4, 4)
    want, got = _both("pool3d", {"X": [x]}, {"pooling_type": "max",
                                             "ksize": [2, 2, 2],
                                             "adaptive": True})
    assert want.shape == got.shape == (1, 2, 3, 3, 3)
    np.testing.assert_array_equal(
        got, F.max_pool3d(torch.from_numpy(x), 2, 1).numpy())


def test_sampled_softmax_draws_uniformly_in_both_packages():
    """With every logit 0 the loss is log(the columns left): each column's
    -log q is the same, so q is uniform (the reference's log-uniform q
    would weigh the columns apart); accidental hits leave the softmax."""
    n, v, s = 64, 50, 20
    logits = np.zeros((n, v), np.float32)
    labels = _rng(3).randint(0, v, (n, 1)).astype(np.int64)
    attrs = {"num_samples": s, "num_true": 1,
             "remove_accidental_hits": False}
    want, got = _both("sampled_softmax_with_cross_entropy",
                      {"Logits": [logits], "Labels": [labels]}, attrs)
    np.testing.assert_allclose(want, np.log(s + 1), rtol=1e-6)
    np.testing.assert_allclose(got, np.log(s + 1), rtol=1e-6)
    gen = torch.Generator().manual_seed(5)
    got, = _lower("sampled_softmax_with_cross_entropy",
                  {"Logits": [torch.zeros(n, v)],
                   "Labels": [torch.from_numpy(labels)]},
                  dict(attrs, remove_accidental_hits=True), gen)["Loss"]
    drawn = torch.randint(0, v, (n, s),
                          generator=torch.Generator().manual_seed(5))
    hits = (drawn == torch.from_numpy(labels)).sum(1, keepdim=True)
    assert int(hits.sum()) > 0
    np.testing.assert_allclose(got.numpy(), np.log(s + 1 - hits.numpy()),
                               rtol=1e-6)


# --------------------------------------------------------------------------
# the random ops, by invariants
# --------------------------------------------------------------------------

def _chi_square_p(ids, probs):
    from scipy import stats
    counts = np.bincount(ids, minlength=len(probs))
    expected = probs * len(ids)
    return stats.chi2.sf(((counts - expected) ** 2 / expected).sum(),
                         len(probs) - 1)


def test_sample_logits_invariants():
    """Samples in range, the labels first; q = log((s + 2) / (s + 1)) /
    log(K + 1); SampledLogits the picked logits less log q, accidental
    hits 1e20 lower; SampledLabels 0 .. NT - 1; the draws log-uniform
    (chi-square p > 1e-4, and uniform fails it); the shapes and dtypes
    the JAX lowering gives."""
    b, k, nt, s = 512, 30, 2, 40
    logits = torch.from_numpy(_randn(b, k))
    labels = torch.from_numpy(_rng(4).randint(0, k, (b, nt)))
    attrs = {"num_samples": s, "remove_accidental_hits": True, "seed": 0}
    out = _lower("sample_logits", {"Logits": [logits], "Labels": [labels]},
                 attrs, torch.Generator().manual_seed(0))
    samples, q = out["Samples"][0], out["Probabilities"][0]
    sl, slab = out["SampledLogits"][0], out["SampledLabels"][0]
    assert samples.shape == (b, nt + s) and samples.dtype == torch.int64
    assert torch.equal(samples[:, :nt], labels)
    assert int(samples.min()) >= 0 and int(samples.max()) < k
    want_q = torch.log((samples + 2.0) / (samples + 1.0)) / math.log(k + 1)
    torch.testing.assert_close(q, want_q, rtol=0, atol=0)
    picked = torch.gather(logits, 1, samples)
    hit = (samples[:, nt:, None] == labels[:, None, :]).any(2)
    assert bool(hit.any())
    want = picked - torch.log(q + 1e-20)
    rest = sl[:, nt:]
    assert bool((rest[hit] < -0.99e20).all())
    torch.testing.assert_close(rest[~hit], want[:, nt:][~hit])
    torch.testing.assert_close(sl[:, :nt], want[:, :nt])
    assert slab.tolist() == [list(range(nt))] * b
    probs = np.log((np.arange(k) + 2.0) / (np.arange(k) + 1.0)) / \
        np.log(k + 1)
    drawn = samples[:, nt:].reshape(-1).numpy()
    assert abs(probs.sum() - 1) < 1e-9
    assert _chi_square_p(drawn, probs) > 1e-4
    assert _chi_square_p(drawn, np.full(k, 1.0 / k)) < 1e-4
    jin, _ = _inputs({"Logits": [logits.numpy()],
                      "Labels": [labels.numpy()]})
    want = jreg.get_lowering("sample_logits")(jreg.LoweringContext(), jin,
                                              attrs)
    assert set(want) == set(out)
    for slot in want:
        assert tuple(want[slot][0].shape) == tuple(out[slot][0].shape)


def test_sample_logits_gradient_adds_along_rows_in_order():
    """The picks' gradient adds repeated samples of a row through
    add_along_rows_, equal to a float64 sum and the same bits twice."""
    b, k = 64, 8
    logits = torch.from_numpy(_randn(b, k)).requires_grad_(True)
    labels = torch.from_numpy(_rng(4).randint(0, k, (b, 1)))
    runs = []
    for _ in range(2):
        out = _lower("sample_logits", {"Logits": [logits],
                                       "Labels": [labels]},
                     {"num_samples": 30, "remove_accidental_hits": False},
                     torch.Generator().manual_seed(1))
        g = torch.from_numpy(_randn(b, 31, seed=5))
        runs.append((torch.autograd.grad(out["SampledLogits"][0], logits,
                                         g)[0], out["Samples"][0]))
    assert torch.equal(runs[0][0], runs[1][0])
    want = torch.zeros(b, k, dtype=torch.float64).scatter_add_(
        1, runs[0][1], g.double())
    assert (runs[0][0].double() - want).abs().max() <= 1e-6


def test_add_along_rows_matches_scatter_add():
    dst = torch.from_numpy(_randn(5, 7))
    idx = torch.from_numpy(_rng(1).randint(0, 7, (5, 12)))
    vals = torch.from_numpy(_randn(5, 12, seed=2))
    want = dst.double().scatter_add(1, idx, vals.double())
    got = misc_nn_ops.add_along_rows_(dst.clone(), idx, vals)
    assert (got.double() - want).abs().max() <= 1e-6


# --------------------------------------------------------------------------
# the row sums and the rest, pinned without the JAX package
# --------------------------------------------------------------------------

def test_hsigmoid_and_tree_conv_add_rows_through_scatter_rows(monkeypatch):
    """hierarchical_sigmoid's W and Bias gradients and tree_conv's child
    sums (and their gradient) add rows through scatter_rows_, the card's
    in-order route, and the same bits come out every run."""
    calls = []
    real = tensor_ops.scatter_rows_

    def counted(dst, rows, vals):
        calls.append(rows.shape[0])
        return real(dst, rows, vals)
    monkeypatch.setattr(tensor_ops, "scatter_rows_", counted)
    monkeypatch.setattr(misc_nn_ops, "scatter_rows_", counted)
    arrays, attrs, _ = CASES["hierarchical_sigmoid"]
    _, tin = _inputs(arrays)
    w, bias = (tin[k][0].requires_grad_(True) for k in ("W", "Bias"))
    runs = []
    for _ in range(2):
        out, = _lower("hierarchical_sigmoid", tin, attrs)["Out"]
        runs.append(torch.autograd.grad(out.sum(), [w, bias]))
    assert calls == [15, 15, 15, 15]     # 5 labels x depth 3, W and Bias
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    calls.clear()
    arrays, attrs, _ = CASES["tree_conv"]
    _, tin = _inputs(arrays)
    nodes = tin["NodesVector"][0].requires_grad_(True)
    out, = _lower("tree_conv", tin, attrs)["Out"]
    torch.autograd.grad(out.sum(), nodes)
    assert calls == [10, 10, 10]     # child sums, counts, the picks' grad


def test_similarity_focus_takes_rows_and_columns_once():
    """A 3x4 plane: min(3, 4) = 3 picks, each on its own row and column,
    greedily from the largest; ties go to the first in row-major order."""
    plane = torch.tensor([[9.0, 1.0, 9.0, 0.0],
                          [8.0, 7.0, 0.0, 0.0],
                          [0.0, 7.0, 6.0, 5.0]])
    out, = _lower("similarity_focus", {"X": [plane[None, None]]},
                  {"axis": 1, "indexes": [0]})["Out"]
    assert out[0, 0].tolist() == [[1, 0, 0, 0], [0, 1, 0, 0],
                                  [0, 0, 1, 0]]


def test_spectral_norm_converges_to_the_largest_singular_value():
    w = torch.from_numpy(_randn(16, 24))
    u, v = torch.from_numpy(_randn(16, seed=1)), torch.from_numpy(
        _randn(24, seed=2))
    for _ in range(40):
        outs = _lower("spectral_norm", {"Weight": [w], "U": [u], "V": [v]},
                      {"dim": 0, "power_iters": 1})
        u, v = outs["UOut"][0], outs["VOut"][0]
    sigma = float(torch.linalg.matrix_norm(w, ord=2))
    got = float(w.norm() / outs["Out"][0].norm())
    assert abs(got - sigma) <= 1e-4 * sigma


def test_bilinear_interp_refuses_out_size_tensor():
    with pytest.raises(NotImplementedError):
        _lower("bilinear_interp", {"X": [torch.zeros(1, 1, 2, 2)],
                                   "OutSize": [torch.tensor([4, 4])]},
               {"out_h": 4, "out_w": 4})
    with pytest.raises(NotImplementedError):
        _lower("affine_grid", {"Theta": [torch.zeros(1, 2, 3)],
                               "OutputShape": [torch.tensor([1, 1, 2, 2])]},
               {})


def test_lowerings_run_on_meta_tensors():
    """Shape inference runs each lowering on meta tensors: every case
    gives the shapes of its CPU run."""
    for case, (arrays, attrs, _) in CASES.items():
        meta = {k: [torch.from_numpy(np.ascontiguousarray(a)).to("meta")
                    for a in v] for k, v in arrays.items()}
        got = treg.infer_outputs(_op(case), meta, attrs)
        _, cpu = _run(_op(case), arrays, attrs)
        for slot in cpu:
            assert [tuple(t.shape) for t in got[slot]] == \
                [tuple(t.shape) for t in cpu[slot]], (case, slot)


def test_spectral_norm_gap_after_twenty_steps_at_dcgan_d_width():
    """One power-iteration step a call on DCGAN D's [512, 256, 4, 4]
    weight drawn N(0, 0.02): after 20 calls sigma sits 1-2.5% under the
    largest singular value (the top of a Gaussian matrix's spectrum is
    crowded), after 60 within 1.2%; sigma never passes it. chip_smoke.py's
    nn_layers phase holds the card's 20 calls to this gap and to float64
    power iteration from the same U and V."""
    rng = np.random.RandomState(19)
    w = torch.from_numpy((rng.randn(512, 256, 4, 4) * 0.02)
                         .astype(np.float32))
    u = torch.from_numpy(rng.randn(512).astype(np.float32))
    v = torch.from_numpy(rng.randn(4096).astype(np.float32))
    sigma_max = float(torch.linalg.matrix_norm(w.reshape(512, -1).double(),
                                               ord=2))
    gaps = {}
    for k in range(1, 61):
        outs = _lower("spectral_norm", {"Weight": [w], "U": [u], "V": [v]},
                      {"dim": 0, "power_iters": 1})
        u, v = outs["UOut"][0], outs["VOut"][0]
        gaps[k] = 1 - float(w.norm() / outs["Out"][0].norm()) / sigma_max
    assert all(g >= -1e-6 for g in gaps.values())
    assert 0.01 <= gaps[20] <= 0.025, gaps[20]
    assert gaps[60] <= 0.012, gaps[60]
    print("gap after 20 calls %.4f, after 60 %.4f" % (gaps[20], gaps[60]))


def test_group_norm_keeps_bf16_where_jax_promotes():
    """A bf16 X with float32 Scale and Bias (what the layer builds in a
    bf16 program): the JAX lowering's Y is float32 (y * scale promotes),
    the port's bf16 as the layer declares, within one bf16 ulp plus 2^-8
    of the JAX lowering's value on X in float32 (ROADMAP Queue 3; the JAX
    lowering normalizes a bf16 X in bf16)."""
    x = _bf16_round(_randn(2, 6, 4, 5) * 3 + 1)
    scale, bias = _randn(6, seed=1), _randn(6, seed=2)
    attrs = {"epsilon": 1e-5, "groups": 3}
    jin = {"X": [jnp.asarray(x).astype(jnp.bfloat16)],
           "Scale": [jnp.asarray(scale)], "Bias": [jnp.asarray(bias)]}
    want, = jreg.get_lowering("group_norm")(jreg.LoweringContext(), jin,
                                            attrs)["Y"]
    tin = {"X": [torch.from_numpy(x).to(torch.bfloat16)],
           "Scale": [torch.from_numpy(scale)],
           "Bias": [torch.from_numpy(bias)]}
    got, = _lower("group_norm", tin, attrs)["Y"]
    assert str(want.dtype) == "float32" and got.dtype == torch.bfloat16
    jin["X"] = [jnp.asarray(x)]
    want, = jreg.get_lowering("group_norm")(jreg.LoweringContext(), jin,
                                            attrs)["Y"]
    _check_bf16(got, _bf16_round(want))


@pytest.mark.parametrize("case", ["conv2d_transpose", "conv3d",
                                  "conv3d_transpose",
                                  "depthwise_conv2d_transpose"])
def test_f32_convolutions_run_in_ieee_precision(case, monkeypatch):
    """A float32 transposed or 3-D convolution's forward and backward run
    with cuDNN's conv precision at "ieee" (no TF32 on the card), as
    conv2d's, and the caller's setting is back after each; bf16 takes the
    plain call at the caller's setting."""
    cudnn = torch.backends.cudnn
    seen = []
    conv, conv_bwd = torch.ops.aten.convolution, \
        torch.ops.aten.convolution_backward

    def spy(name, fn):
        def call(*args, **kw):
            seen.append((name, cudnn.conv.fp32_precision))
            return fn(*args, **kw)
        return call
    monkeypatch.setattr(torch.ops.aten, "convolution", spy("forward", conv))
    monkeypatch.setattr(torch.ops.aten, "convolution_backward",
                        spy("backward", conv_bwd))
    before = cudnn.conv.fp32_precision
    arrays, attrs, slot = CASES[case]
    _, tin = _inputs(arrays)
    x = tin["Input"][0].requires_grad_(True)
    out, = _lower(case, tin, attrs)[slot]
    assert cudnn.conv.fp32_precision == before
    out.sum().backward()
    assert cudnn.conv.fp32_precision == before
    assert seen == [("forward", "ieee"), ("backward", "ieee")]
    seen.clear()
    _, tin = _inputs(arrays, bf16=True)
    _lower(case, tin, attrs)
    assert seen == [("forward", before)]
