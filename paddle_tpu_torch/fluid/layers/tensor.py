"""Tensor layers (the port's counterpart of
``paddle_tpu/fluid/layers/tensor.py``): variable and parameter creation,
cast, concat, sums, assign, fill_constant, ones, zeros and isfinite. The
rest of the JAX module's layers come with their ops."""
import numpy as np

from ..core_types import convert_dtype
from ..framework import Variable
from ..initializer import Constant
from ..layer_helper import LayerHelper

__all__ = ["create_tensor", "create_parameter", "create_global_var", "cast",
           "concat", "sums", "assign", "fill_constant", "ones", "zeros",
           "isfinite"]


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_variable(name=helper.name, dtype=dtype,
                                  persistable=persistable)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..param_attr import ParamAttr
    helper = LayerHelper("create_parameter", name=name)
    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A global var of ``shape`` that the startup program fills with
    ``value``."""
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(name=helper.name if name is None
                                        else name, dtype=dtype,
                                        shape=list(shape),
                                        persistable=persistable)
    helper.set_variable_initializer(var, Constant(value=float(value)))
    return var


def cast(x, dtype):
    helper = LayerHelper("cast", input=x)
    dtype = convert_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", input=input, name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type="concat", inputs={"X": list(input)},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def sums(input, out=None):
    helper = LayerHelper("sum", input=input)
    if out is None:
        out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type="sum", inputs={"X": list(input)},
                     outputs={"Out": [out]})
    return out


def assign(input, output=None):
    """Copy a Variable into ``output`` (a new var by default). A numpy
    array takes the assign_value op, which is not ported yet."""
    helper = LayerHelper("assign")
    if isinstance(input, np.ndarray):
        raise NotImplementedError("assign of a numpy array (the assign_value "
                                  "op) is not ported yet")
    if not isinstance(input, Variable):
        raise TypeError("assign expects Variable or ndarray")
    if output is None:
        output = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="assign", inputs={"X": [input]},
                     outputs={"Out": [output]})
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(convert_dtype(dtype))
    helper.append_op(type="fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": convert_dtype(dtype),
                            "value": float(value)})
    out.stop_gradient = True
    return out


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=1.0)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=0.0)


def isfinite(x):
    """A [1] bool: are all of x's elements finite?"""
    helper = LayerHelper("isfinite", input=x)
    out = helper.create_variable_for_type_inference("bool",
                                                    stop_gradient=True)
    helper.append_op(type="isfinite", inputs={"X": [x]}, outputs={"Out": [out]})
    return out
