"""The 16 OpTest cases of tests/test_ops_numeric.py on the port, through
tests/torch_op_test.py: each case's own setup (the same inputs, numpy
expectations and attrs) and test method (the same checks and tolerances),
with the port's OpTest in place of the JAX package's. The outputs are held
to numpy and the analytic gradients (``calc_gradient``) to central
differences: an oracle for every op these cases cover that does not
depend on the JAX package. Five cases of the NN lowerings
(conv2d_transpose, group_norm, lrn, grid_sampler,
bilinear_tensor_product) are written here on the same harness, each
against its own numpy formula.
"""
import numpy as np
import pytest

import test_ops_numeric as cases
from torch_op_test import OpTest

CASES = sorted(name for name, c in vars(cases).items()
               if isinstance(c, type) and issubclass(c, cases.OpTest) and
               c is not cases.OpTest)


def test_all_sixteen_cases_are_here():
    assert len(CASES) == 16


@pytest.mark.parametrize("name", CASES)
def test_case_on_the_port(name):
    case = getattr(cases, name)
    on_port = type(name, (OpTest,), {"op_type": case.op_type,
                                     "setup": case.setup})
    case.test(on_port())


# --------------------------------------------------------------------------
# the NN lowerings of the slice, held to numpy and to central differences
# --------------------------------------------------------------------------

def _conv_transpose_np(x, w, stride, pad, groups):
    """Each input pixel scatters its filter, stride apart, into the output;
    the padding is cut off each side. w: [in_c, out_c / groups, kh, kw]."""
    n, c, h, wd = x.shape
    _, ocg, kh, kw = w.shape
    cg = c // groups
    full = np.zeros((n, ocg * groups, (h - 1) * stride + kh,
                     (wd - 1) * stride + kw))
    for b in range(n):
        for ci in range(c):
            g = ci // cg
            for i in range(h):
                for j in range(wd):
                    full[b, g * ocg:(g + 1) * ocg, i * stride:i * stride + kh,
                         j * stride:j * stride + kw] += x[b, ci, i, j] * w[ci]
    return full[:, :, pad:full.shape[2] - pad, pad:full.shape[3] - pad]


class Conv2dTransposeCase(object):
    op_type = "conv2d_transpose"

    def setup(self):
        rng = np.random.RandomState(11)
        x = rng.rand(1, 4, 3, 3).astype("float32")
        w = rng.rand(4, 1, 3, 3).astype("float32")
        self.inputs = {"Input": [("x", x)], "Filter": [("w", w)]}
        self.attrs = {"strides": [2, 2], "paddings": [1, 1], "groups": 2}
        self.outputs = {"Output": [("out", _conv_transpose_np(x, w, 2, 1,
                                                               2))]}

    def test(self):
        self.check_output(atol=1e-5)
        self.check_grad(["x", "w"], "out", max_relative_error=1e-2)


class GroupNormCase(object):
    op_type = "group_norm"

    def setup(self):
        rng = np.random.RandomState(12)
        x = rng.randn(2, 4, 2, 3).astype("float32")
        scale = rng.rand(4).astype("float32") + 0.5
        bias = rng.randn(4).astype("float32")
        xg = x.astype(np.float64).reshape(2, 2, -1)
        mean = xg.mean(-1, keepdims=True)
        var = xg.var(-1, keepdims=True)
        y = ((xg - mean) / np.sqrt(var + 1e-5)).reshape(x.shape) * \
            scale.reshape(1, 4, 1, 1) + bias.reshape(1, 4, 1, 1)
        self.inputs = {"X": [("x", x)], "Scale": [("scale", scale)],
                       "Bias": [("bias", bias)]}
        self.attrs = {"groups": 2, "epsilon": 1e-5}
        self.outputs = {"Y": [("y", y)], "Mean": [("mean", mean.reshape(2,
                                                                        2))],
                        "Variance": [("var", var.reshape(2, 2))]}

    def test(self):
        self.check_output(atol=1e-5)
        self.check_grad(["x", "scale", "bias"], "y", max_relative_error=1e-2)


class LrnCase(object):
    op_type = "lrn"

    def setup(self):
        rng = np.random.RandomState(13)
        x = rng.randn(1, 5, 2, 2).astype("float32")
        sq = np.pad(x.astype(np.float64) ** 2, [(0, 0), (2, 2), (0, 0),
                                                (0, 0)])
        mid = 2.0 + 0.1 * sum(sq[:, i:i + 5] for i in range(5))
        self.inputs = {"X": [("x", x)]}
        self.attrs = {"n": 5, "k": 2.0, "alpha": 0.1, "beta": 0.75}
        self.outputs = {"Out": [("out", x / mid ** 0.75)],
                        "MidOut": [("mid", mid)]}

    def test(self):
        self.check_output(atol=1e-5)
        self.check_grad(["x"], "out")


def _grid_sample_np(x, grid):
    """Bilinear at (g + 1) * (size - 1) / 2, the border's value outside."""
    n, c, h, w = x.shape
    out = np.zeros((n, c) + grid.shape[1:3])
    for b in range(n):
        for i in range(grid.shape[1]):
            for j in range(grid.shape[2]):
                gx = np.clip((grid[b, i, j, 0] + 1) * (w - 1) / 2, 0, w - 1)
                gy = np.clip((grid[b, i, j, 1] + 1) * (h - 1) / 2, 0, h - 1)
                x0, y0 = int(np.floor(gx)), int(np.floor(gy))
                x1, y1 = min(x0 + 1, w - 1), min(y0 + 1, h - 1)
                fx, fy = gx - x0, gy - y0
                out[b, :, i, j] = (x[b, :, y0, x0] * (1 - fx) * (1 - fy) +
                                   x[b, :, y0, x1] * fx * (1 - fy) +
                                   x[b, :, y1, x0] * (1 - fx) * fy +
                                   x[b, :, y1, x1] * fx * fy)
    return out


class GridSamplerCase(object):
    op_type = "grid_sampler"

    def setup(self):
        rng = np.random.RandomState(14)
        x = rng.rand(1, 2, 3, 4).astype("float32")
        # coordinates 0.1 or more from every pixel centre (where the
        # derivative jumps), one past the border
        grid = np.array([[[[-0.8, -0.5], [0.25, 0.3]],
                          [[0.55, 0.8], [1.4, 0.3]]]], np.float32)
        self.inputs = {"X": [("x", x)], "Grid": [("grid", grid)]}
        self.outputs = {"Output": [("out", _grid_sample_np(x, grid))]}

    def test(self):
        self.check_output(atol=1e-5)
        self.check_grad(["x", "grid"], "out")


class BilinearTensorProductCase(object):
    op_type = "bilinear_tensor_product"

    def setup(self):
        rng = np.random.RandomState(15)
        x = rng.rand(3, 4).astype("float32")
        y = rng.rand(3, 2).astype("float32")
        w = rng.rand(5, 4, 2).astype("float32")
        b = rng.rand(1, 5).astype("float32")
        self.inputs = {"X": [("x", x)], "Y": [("y", y)],
                       "Weight": [("w", w)], "Bias": [("b", b)]}
        self.outputs = {"Out": [("out", np.einsum("bi,oij,bj->bo", x, w, y) +
                                 b)]}

    def test(self):
        self.check_output(atol=1e-5)
        self.check_grad(["x", "y", "w", "b"], "out")


NN_CASES = [Conv2dTransposeCase, GroupNormCase, LrnCase, GridSamplerCase,
            BilinearTensorProductCase]


@pytest.mark.parametrize("case", NN_CASES, ids=lambda c: c.op_type)
def test_nn_case_on_the_port(case):
    """The slice's NN lowerings against numpy and central differences
    (no JAX package on the path)."""
    on_port = type(case.__name__, (OpTest,), {"op_type": case.op_type,
                                              "setup": case.setup})
    case.test(on_port())
