"""Initializers: append init ops to the startup program.

The port's counterpart of ``paddle_tpu/fluid/initializer.py``: Constant,
Uniform, Normal, TruncatedNormal, Xavier, MSRA, Bilinear and
NumpyArrayInitializer emit the same startup ops with the same attrs
(``fill_constant``, ``uniform_random``, ``gaussian_random``,
``truncated_gaussian_random``, ``assign_value``); the executor draws their
random values from the run's ``torch.Generator``. Every initializer runs
on the executor's device, so ``force_init_on_cpu`` is False and
``init_on_cpu`` changes nothing, as in the JAX package.
"""
import contextlib

import numpy as np

__all__ = ["Constant", "Uniform", "Normal", "TruncatedNormal", "Xavier",
           "MSRA", "Bilinear", "NumpyArrayInitializer", "force_init_on_cpu",
           "init_on_cpu", "ConstantInitializer", "UniformInitializer",
           "NormalInitializer", "TruncatedNormalInitializer",
           "XavierInitializer", "MSRAInitializer", "BilinearInitializer"]


def force_init_on_cpu():
    return False


@contextlib.contextmanager
def init_on_cpu():
    yield


class Initializer(object):
    def __call__(self, var, block):
        raise NotImplementedError()

    @staticmethod
    def _compute_fans(var):
        shape = var.shape
        if not shape or len(shape) == 0:
            return 1, 1
        if len(shape) == 1:
            return shape[0], shape[0]
        if len(shape) == 2:
            return shape[0], shape[1]
        receptive = int(np.prod(shape[2:]))
        return shape[1] * receptive, shape[0] * receptive


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self._value = value

    def __call__(self, var, block):
        return block.append_op(
            type="fill_constant", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "value": float(self._value)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self._low = low
        self._high = high
        self._seed = seed

    def __call__(self, var, block):
        return block.append_op(
            type="uniform_random", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "min": self._low, "max": self._high, "seed": self._seed})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self._mean = loc
        self._std_dev = scale
        self._seed = seed

    def __call__(self, var, block):
        return block.append_op(
            type="gaussian_random", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": self._mean, "std": self._std_dev,
                   "seed": self._seed})


class TruncatedNormalInitializer(Initializer):
    """mean + std * z, z a standard normal truncated to [-2, 2], not
    rescaled to unit variance."""

    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self._mean = loc
        self._std_dev = scale
        self._seed = seed

    def __call__(self, var, block):
        return block.append_op(
            type="truncated_gaussian_random", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": self._mean, "std": self._std_dev,
                   "seed": self._seed})


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self._uniform = uniform
        self._fan_in = fan_in
        self._fan_out = fan_out
        self._seed = seed

    def __call__(self, var, block):
        fin, fout = self._compute_fans(var)
        fin = self._fan_in if self._fan_in is not None else fin
        fout = self._fan_out if self._fan_out is not None else fout
        if self._uniform:
            limit = float(np.sqrt(6.0 / (fin + fout)))
            return block.append_op(
                type="uniform_random", outputs={"Out": [var.name]},
                attrs={"shape": list(var.shape), "dtype": var.dtype,
                       "min": -limit, "max": limit, "seed": self._seed})
        std = float(np.sqrt(2.0 / (fin + fout)))
        return block.append_op(
            type="gaussian_random", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": 0.0, "std": std, "seed": self._seed})


class MSRAInitializer(Initializer):
    """He initialization: uniform on +-sqrt(6 / fan_in), or normal with std
    sqrt(2 / fan_in)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self._uniform = uniform
        self._fan_in = fan_in
        self._seed = seed

    def __call__(self, var, block):
        fin, _ = self._compute_fans(var)
        fin = self._fan_in if self._fan_in is not None else fin
        if self._uniform:
            limit = float(np.sqrt(6.0 / fin))
            return block.append_op(
                type="uniform_random", outputs={"Out": [var.name]},
                attrs={"shape": list(var.shape), "dtype": var.dtype,
                       "min": -limit, "max": limit, "seed": self._seed})
        std = float(np.sqrt(2.0 / fin))
        return block.append_op(
            type="gaussian_random", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": 0.0, "std": std, "seed": self._seed})


class BilinearInitializer(Initializer):
    """For upsampling deconv filters (reference: initializer.py Bilinear):
    a 4-D filter whose [k, k] kernels on the channel diagonal (or on input
    channel 0 when the channel counts differ) hold the bilinear kernel,
    zeros elsewhere; through NumpyArrayInitializer."""

    def __call__(self, var, block):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError("Bilinear init expects a 4-D filter")
        weight = np.zeros(shape, dtype="float32")
        size = shape[3]
        factor = (size + 1) // 2
        center = factor - 1 if size % 2 == 1 else factor - 0.5
        og = np.ogrid[:size, :size]
        filt = (1 - abs(og[0] - center) / factor) * \
               (1 - abs(og[1] - center) / factor)
        weight[range(shape[0]), range(shape[1]) if shape[1] == shape[0]
               else 0, :, :] = filt
        return NumpyArrayInitializer(weight)(var, block)


class NumpyArrayInitializer(Initializer):
    """The array's values, through an assign_value op (a float64 list)."""

    def __init__(self, value):
        self._value = np.asarray(value)

    def __call__(self, var, block):
        return block.append_op(
            type="assign_value", outputs={"Out": [var.name]},
            attrs={"shape": list(self._value.shape), "dtype": var.dtype,
                   "values": self._value.astype(np.float64).tolist()})


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer
