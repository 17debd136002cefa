"""Generated activation layers and a few math layers (the port's
counterpart of ``paddle_tpu/fluid/layers/ops.py``): one layer a lowering of
the activation set, and uniform_random, cumsum, sign and increment."""
from ..layer_helper import LayerHelper

__activations__ = [
    "softshrink", "exp", "tanh", "tanh_shrink", "softplus",
    "softsign", "sqrt", "abs", "ceil", "floor", "cos", "sin", "round",
    "reciprocal", "square", "acos", "asin", "atan", "logsigmoid",
    "hard_shrink", "stanh", "thresholded_relu", "gelu",
]

__all__ = list(__activations__) + [
    "uniform_random", "hard_shrink", "cumsum", "thresholded_relu",
    "sign", "increment",
]


def _make_act(op_type):
    def layer(x, name=None, **kwargs):
        helper = LayerHelper(op_type, input=x, name=name)
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs=kwargs)
        return out
    layer.__name__ = op_type
    return layer


for _op in __activations__:
    globals()[_op] = _make_act(_op)


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="uniform_random", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype, "min": min,
                            "max": max, "seed": seed})
    return out


def cumsum(x, axis=-1, exclusive=False, reverse=False):
    helper = LayerHelper("cumsum", input=x)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="cumsum", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis, "exclusive": exclusive,
                            "reverse": reverse})
    return out


def sign(x):
    helper = LayerHelper("sign", input=x)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sign", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def increment(x, value=1.0, in_place=True):
    """x + value; in place (the default) the op writes x itself."""
    helper = LayerHelper("increment", input=x)
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out
