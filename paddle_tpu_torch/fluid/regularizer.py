"""Weight-decay regularizers appended as ops on gradients.

The port's counterpart of ``paddle_tpu/fluid/regularizer.py``: the same ops
and var names. Decay applies to the whole table, so a sparse (values, rows)
gradient pair is densified before the sum.
"""
from . import sparse_grads
from .core_types import OpRole

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class WeightDecayRegularizer(object):
    def __call__(self, param, grad, block):
        raise NotImplementedError()


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = block.create_var(name=grad.name + "@L2DECAY",
                                 shape=param.shape, dtype=param.dtype)
        block.append_op(type="scale", inputs={"X": [param.name]},
                        outputs={"Out": [decay.name]},
                        attrs={"scale": self._regularization_coeff,
                               OpRole.KEY: OpRole.Backward})
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        sign = block.create_var(name=grad.name + "@L1SIGN",
                                shape=param.shape, dtype=param.dtype)
        block.append_op(type="sign", inputs={"X": [param.name]},
                        outputs={"Out": [sign.name]},
                        attrs={OpRole.KEY: OpRole.Backward})
        decay = block.create_var(name=grad.name + "@L1DECAY",
                                 shape=param.shape, dtype=param.dtype)
        block.append_op(type="scale", inputs={"X": [sign.name]},
                        outputs={"Out": [decay.name]},
                        attrs={"scale": self._regularization_coeff,
                               OpRole.KEY: OpRole.Backward})
        return decay


def append_regularization_ops(parameters_and_grads, regularization=None):
    params_and_grads = []
    for param, grad in parameters_and_grads:
        if grad is None:
            params_and_grads.append((param, grad))
            continue
        regularization_term = None
        block = grad.block
        if param.regularizer is not None:
            regularization_term = param.regularizer(param, grad, block)
        elif regularization is not None:
            regularization_term = regularization(param, grad, block)
        if regularization_term is None:
            params_and_grads.append((param, grad))
            continue
        grad = sparse_grads.densify(block, param, grad)
        new_grad = block.create_var(name=grad.name + "@REGULARIZED",
                                    shape=param.shape, dtype=param.dtype)
        block.append_op(type="sum",
                        inputs={"X": [grad.name, regularization_term.name]},
                        outputs={"Out": [new_grad.name]},
                        attrs={OpRole.KEY: OpRole.Backward})
        params_and_grads.append((param, new_grad))
    return params_and_grads


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
