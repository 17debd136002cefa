"""Initializers: append init ops to the startup program.

The port's counterpart of ``paddle_tpu/fluid/initializer.py``: Constant,
Uniform, Normal and Xavier emit the same startup ops with the same attrs
(``fill_constant``, ``uniform_random``, ``gaussian_random``); the executor
draws their random values from the run's ``torch.Generator``.
"""
import numpy as np

__all__ = ["Constant", "Uniform", "Normal", "Xavier", "ConstantInitializer",
           "UniformInitializer", "NormalInitializer", "XavierInitializer"]


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


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
