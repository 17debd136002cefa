"""Control-flow layers (the port's counterpart of
``paddle_tpu/fluid/layers/control_flow.py``): so far the comparison layers
(less_than ... not_equal, each a bool output), is_empty and increment.
While, Switch, IfElse, the RNNs and the tensor arrays come with the
control-flow slice of the port."""
from ..layer_helper import LayerHelper

__all__ = ["less_than", "less_equal", "greater_than", "greater_equal",
           "equal", "not_equal", "increment", "is_empty"]


def _cmp_layer(op_type):
    def layer(x, y, cond=None):
        helper = LayerHelper(op_type, input=x)
        if cond is None:
            cond = helper.create_variable_for_type_inference("bool")
        cond.stop_gradient = True
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [cond]})
        return cond
    layer.__name__ = op_type
    return layer


def less_than(x, y, force_cpu=None, cond=None):
    """x < y elementwise (force_cpu is taken for the reference's signature;
    the op runs where its inputs lie)."""
    return _cmp_layer("less_than")(x, y, cond=cond)


less_equal = _cmp_layer("less_equal")
greater_than = _cmp_layer("greater_than")
greater_equal = _cmp_layer("greater_equal")
equal = _cmp_layer("equal")
not_equal = _cmp_layer("not_equal")


def increment(x, value=1.0, in_place=True):
    from .ops import increment as _inc
    return _inc(x, value, in_place)


def is_empty(x, cond=None):
    helper = LayerHelper("is_empty", input=x)
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
    cond.stop_gradient = True
    helper.append_op(type="is_empty", inputs={"X": [x]},
                     outputs={"Out": [cond]})
    return cond
