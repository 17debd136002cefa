"""Operator sugar for compile-time Variables (the port's counterpart of
``paddle_tpu/fluid/layers/math_op_patch.py``): ``a + b``, ``1.0 - p`` and
the like append elementwise ops, a Python scalar first becoming a [1]
``fill_constant``."""
from .. import unique_name
from ..framework import Variable
from ..layer_helper import LayerHelper


def _create_scalar_tensor(block, value, dtype):
    name = unique_name.generate("scalar_const")
    var = block.create_var(name=name, shape=(1,), dtype=dtype or "float32")
    block.append_op(type="fill_constant", outputs={"Out": [name]},
                     attrs={"shape": [1], "value": float(value),
                            "dtype": dtype or "float32"})
    return var


def binary(x, other, op):
    """``x <op> other``; an ``op`` ending in "_r" swaps the operands."""
    helper = LayerHelper(op)
    reversed_ = op.endswith("_r")
    if reversed_:
        op = op[:-2]
    if not isinstance(other, Variable):
        other = _create_scalar_tensor(x.block, other, x.dtype)
    a, b = (other, x) if reversed_ else (x, other)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type=op, inputs={"X": [a], "Y": [b]},
                     outputs={"Out": [out]}, attrs={"axis": -1})
    return out
