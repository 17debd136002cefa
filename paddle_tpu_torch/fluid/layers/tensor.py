"""Tensor layers (the port's counterpart of
``paddle_tpu/fluid/layers/tensor.py``): variable and parameter creation,
cast, concat, sums, assign (of a Variable or a numpy array), the fills,
argmin, argmax, argsort, reverse, has_inf, has_nan, isfinite, range and
tensor_array_to_tensor."""
import numpy as np

from ..core_types import convert_dtype
from ..framework import Variable
from ..initializer import Constant
from ..layer_helper import LayerHelper

__all__ = [
    "tensor_array_to_tensor",
    "create_tensor", "create_parameter", "create_global_var", "cast",
    "concat", "sums", "assign", "fill_constant_batch_size_like",
    "fill_constant", "argmin", "argmax", "argsort", "ones", "zeros",
    "reverse", "has_inf", "has_nan", "isfinite", "range", "zeros_like",
    "ones_like",
]


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
    """Copy a Variable into ``output`` (a new var by default), or put a
    numpy array there through an assign_value op (its values a float64
    list)."""
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op(type="assign", inputs={"X": [input]},
                         outputs={"Out": [output]})
    elif isinstance(input, np.ndarray):
        if output is None:
            output = helper.create_variable_for_type_inference(
                str(input.dtype))
        helper.append_op(
            type="assign_value", outputs={"Out": [output]},
            attrs={"shape": list(input.shape), "dtype": str(input.dtype),
                   "values": input.astype(np.float64).tolist()})
    else:
        raise TypeError("assign expects Variable or ndarray")
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


def fill_constant_batch_size_like(input, shape, dtype, value, input_dim_idx=0,
                                  output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like", input=input)
    out = helper.create_variable_for_type_inference(convert_dtype(dtype))
    helper.append_op(type="fill_constant_batch_size_like",
                     inputs={"Input": [input]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": convert_dtype(dtype),
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    static = list(shape)
    static[output_dim_idx] = -1       # batch dim comes from the input
    out.shape = tuple(static)
    out.stop_gradient = True
    return out


def argmin(x, axis=0):
    helper = LayerHelper("arg_min", input=x)
    out = helper.create_variable_for_type_inference("int64",
                                                    stop_gradient=True)
    helper.append_op(type="arg_min", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def argmax(x, axis=0):
    helper = LayerHelper("arg_max", input=x)
    out = helper.create_variable_for_type_inference("int64",
                                                    stop_gradient=True)
    helper.append_op(type="arg_max", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def argsort(input, axis=-1, name=None):
    helper = LayerHelper("argsort", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    stop_gradient=True)
    ids = helper.create_variable_for_type_inference("int64",
                                                    stop_gradient=True)
    helper.append_op(type="argsort", inputs={"X": [input]},
                     outputs={"Out": [out], "Indices": [ids]},
                     attrs={"axis": axis})
    return out, ids


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=1.0)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=0.0)


def reverse(x, axis):
    from .nn import reverse as _rev
    return _rev(x, axis)


def has_inf(x):
    helper = LayerHelper("isinf", input=x)
    out = helper.create_variable_for_type_inference("bool",
                                                    stop_gradient=True)
    helper.append_op(type="isinf", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def has_nan(x):
    helper = LayerHelper("isnan", input=x)
    out = helper.create_variable_for_type_inference("bool",
                                                    stop_gradient=True)
    helper.append_op(type="isnan", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def isfinite(x):
    """A [1] bool: are all of x's elements finite?"""
    helper = LayerHelper("isfinite", input=x)
    out = helper.create_variable_for_type_inference("bool",
                                                    stop_gradient=True)
    helper.append_op(type="isfinite", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def range(start, end, step, dtype):
    helper = LayerHelper("range")
    out = helper.create_variable_for_type_inference(convert_dtype(dtype),
                                                    stop_gradient=True)
    helper.append_op(type="range_static", outputs={"Out": [out]},
                     attrs={"start": float(start), "end": float(end),
                            "step": float(step), "dtype": convert_dtype(dtype)})
    return out


def zeros_like(x, out=None):
    helper = LayerHelper("fill_zeros_like", input=x)
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype,
                                                        stop_gradient=True)
    helper.append_op(type="fill_zeros_like", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def ones_like(x, out=None):
    """Ones in x's shape and dtype, through a fill_constant_batch_size_like
    op (the JAX package's layer)."""
    helper = LayerHelper("fill_ones_like", input=x)
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype,
                                                        stop_gradient=True)
    helper.append_op(type="fill_constant_batch_size_like",
                     inputs={"Input": [x]}, outputs={"Out": [out]},
                     attrs={"shape": list(x.shape), "dtype": x.dtype,
                            "value": 1.0})
    return out


def tensor_array_to_tensor(input, axis=1, name=None):
    """Concat a tensor array into one tensor (reference
    tensor_array_to_tensor_op.cc). Returns (out, out_index: per-entry sizes
    along axis)."""
    helper = LayerHelper("tensor_array_to_tensor", input=input, name=name)
    out = helper.create_variable_for_type_inference(
        getattr(input, "dtype", "float32"))
    out_index = helper.create_variable_for_type_inference(
        "int32", stop_gradient=True)
    helper.append_op(type="tensor_array_to_tensor",
                     inputs={"X": [input]},
                     outputs={"Out": [out], "OutIndex": [out_index]},
                     attrs={"axis": axis})
    return out, out_index
