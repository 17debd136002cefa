"""LayerHelper: the bridge between layer functions and the IR.

The port's counterpart of ``paddle_tpu/fluid/layer_helper.py``. Compile-time
shape inference runs the op's own PyTorch lowering on ``device="meta"``
tensors (no data, no compute), where the JAX package abstract-evaluates
its XLA lowering with ``jax.eval_shape``.
"""
import copy

import torch

from . import unique_name
from .framework import default_main_program, default_startup_program
from .core_types import convert_dtype, dtype_is_floating, to_torch_dtype
from .initializer import Constant, Xavier
from .param_attr import ParamAttr
from .ops import registry as op_registry

# sentinel standing in for the dynamic batch dim (-1) during shape inference;
# the same value as the JAX package so reshape2 with [0, 0, H, D] infers the
# same shapes
_BATCH_SENTINEL = 97


class LayerHelper(object):
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = self.kwargs.get("name", None)
        if name is None:
            self.kwargs["name"] = unique_name.generate(layer_type)

    @property
    def name(self):
        return self.kwargs["name"]

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    # ---- inputs ----
    def multiple_input(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name, [])
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        return list(inputs)

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr", None))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("bias_attr", None))

    def multiple_param_attr(self, length):
        attr = self.param_attr
        if isinstance(attr, ParamAttr):
            attr = [copy.deepcopy(attr) for _ in range(length)]
        return attr

    def input_dtype(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        dtype = None
        for v in inputs:
            if dtype is None:
                dtype = v.dtype
            elif dtype != v.dtype:
                raise ValueError("mismatched input dtypes")
        return dtype

    # ---- variable/parameter creation ----
    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        if attr is False:
            return None
        attr = attr if isinstance(attr, ParamAttr) else \
            ParamAttr._to_attr(attr)
        if default_initializer is None:
            if is_bias:
                attr._set_default_bias_initializer()
            else:
                if dtype_is_floating(dtype):
                    attr._set_default_param_initializer()
                else:
                    attr._set_default_initializer(Constant(0.0))
        else:
            attr._set_default_initializer(default_initializer)
        if attr.name is None:
            attr.name = unique_name.generate(".".join(
                [self.name, "b" if is_bias else "w"]))

        main_block = self.main_program.global_block()
        if main_block.has_var(attr.name):
            return main_block.var(attr.name)
        kwargs = {k: v for k, v in attr._to_kwargs().items() if k != "name"}
        param = main_block.create_parameter(
            name=attr.name, shape=shape, dtype=dtype, **kwargs)
        # mirrored var + init op in the startup program
        sb = self.startup_program.global_block()
        sv = sb.create_parameter(name=attr.name, shape=shape, dtype=dtype,
                                 **kwargs)
        initializer = attr.initializer or (Constant(0.0) if is_bias
                                           else Xavier())
        initializer(sv, sb)
        return param

    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        return self.main_program.current_block().create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype, stop_gradient=stop_gradient)

    def create_variable(self, *args, **kwargs):
        return self.main_program.current_block().create_var(*args, **kwargs)

    def create_global_variable(self, persistable=False, *args, **kwargs):
        return self.main_program.global_block().create_var(
            *args, persistable=persistable, **kwargs)

    def set_variable_initializer(self, var, initializer):
        """Mirror persistable ``var`` into the startup program with
        ``initializer``'s op."""
        sb = self.startup_program.global_block()
        sb.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                      persistable=True)
        initializer(var, sb)

    # ---- op creation + shape inference ----
    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        block = self.main_program.current_block()
        op = block.append_op(type=type, inputs=inputs, outputs=outputs,
                             attrs=attrs)
        infer_shapes_for_op(block, op)
        return op

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        size = list(input_var.shape[dim_start:dim_end])
        if any(s is None or s < 0 for s in size):
            raise ValueError("cannot infer bias size from shape %s"
                             % (input_var.shape,))
        b = self.create_parameter(attr=self.bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        if b is None:
            return input_var
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(
            type="elementwise_add",
            inputs={"X": [input_var], "Y": [b]},
            outputs={"Out": [tmp]},
            attrs={"axis": dim_start})
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act", None)
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        else:
            act = copy.deepcopy(act)
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(type=act_type, inputs={"X": [input_var]},
                       outputs={"Out": [tmp]}, attrs=act)
        return tmp


def _meta_of(var):
    if var is None or var.shape is None:
        return None
    shape = tuple(_BATCH_SENTINEL if (d is None or d < 0) else d
                  for d in var.shape)
    return torch.empty(shape, dtype=to_torch_dtype(var.dtype or "float32"),
                       device="meta")


def infer_shapes_for_op(block, op):
    """Set output var shapes/dtypes by running the lowering on meta tensors."""
    if not op_registry.has_lowering(op.type):
        return
    input_metas = {}
    for slot, names in op.inputs.items():
        metas = []
        for n in names:
            if n == "@EMPTY@":
                metas.append(None)
                continue
            try:
                metas.append(_meta_of(block._var_recursive(n)))
            except ValueError:
                metas.append(None)
        input_metas[slot] = metas
    try:
        out = op_registry.infer_outputs(op.type, input_metas, op.attrs)
    except Exception:
        return  # dynamic/unsupported at build time; runtime shapes still exact
    for slot, names in op.outputs.items():
        metas = out.get(slot)
        if metas is None:
            continue
        for i, n in enumerate(names):
            if n == "@EMPTY@" or i >= len(metas) or metas[i] is None or \
                    not hasattr(metas[i], "shape"):
                continue
            try:
                var = block._var_recursive(n)
            except ValueError:
                continue
            var.shape = tuple(-1 if d == _BATCH_SENTINEL else int(d)
                              for d in metas[i].shape)
            if var.dtype is None:
                var.dtype = convert_dtype(metas[i].dtype)
