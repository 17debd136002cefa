"""Gradient clipping, rewriting grads with clip ops.

The port's counterpart of ``paddle_tpu/fluid/clip.py``: the same clip
attrs, ops and var names. A clip needs the dense gradient, so a sparse
(values, rows) pair is densified first.
"""
from .framework import default_main_program
from .core_types import OpRole
from . import sparse_grads
from . import unique_name

__all__ = ["GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "set_gradient_clip",
           "append_gradient_clip_ops", "error_clip_callback"]


def error_clip_callback(block, context):
    """The backward callback Optimizer.minimize passes, as in the JAX
    package; it adds no op."""


class BaseGradientClipAttr(object):
    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        raise NotImplementedError()


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def _create_operators(self, param, grad):
        block = grad.block
        out = block.create_var(name=grad.name + "@CLIP", shape=param.shape,
                               dtype=param.dtype)
        block.append_op(type="clip", inputs={"X": [grad.name]},
                        outputs={"Out": [out.name]},
                        attrs={"min": self.min, "max": self.max,
                               OpRole.KEY: OpRole.Backward})
        return param, out


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _create_operators(self, param, grad):
        block = grad.block
        out = block.create_var(name=grad.name + "@CLIP", shape=param.shape,
                               dtype=param.dtype)
        block.append_op(type="clip_by_norm", inputs={"X": [grad.name]},
                        outputs={"Out": [out.name]},
                        attrs={"max_norm": self.clip_norm,
                               OpRole.KEY: OpRole.Backward})
        return param, out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _process_context(self, context, param, grad):
        if self.group_name not in context:
            context[self.group_name] = []
            context[self.group_name + "_clip_value"] = self.clip_norm
        elif context[self.group_name + "_clip_value"] != self.clip_norm:
            raise ValueError("all parameters' 'clip_norm' of a same group "
                             "should be the same")
        block = grad.block
        sq = block.create_var(name=unique_name.generate(grad.name + "@SQN"),
                              shape=(1,), dtype=param.dtype)
        block.append_op(type="squared_l2_norm", inputs={"X": [grad.name]},
                        outputs={"Out": [sq.name]},
                        attrs={OpRole.KEY: OpRole.Backward})
        context[self.group_name].append(sq)
        context.setdefault(self.group_name + "_pairs", []).append((param, grad))

    def _create_operators(self, param, grad):
        # actual ops are emitted in append_gradient_clip_ops once per group
        return param, grad


_gradient_clip_attr = None


def set_gradient_clip(clip, param_list=None, program=None):
    global _gradient_clip_attr
    program = program or default_main_program()
    if param_list is not None:
        params = [program.global_block()._var_recursive(p)
                  if isinstance(p, str) else p for p in param_list]
        for p in params:
            p.gradient_clip_attr = clip
    else:
        _gradient_clip_attr = clip


def append_gradient_clip_ops(param_grads):
    context = {}
    result = []
    global_norm_groups = {}
    for p, g in param_grads:
        if g is None:
            result.append((p, g))
            continue
        clip_attr = p.gradient_clip_attr or _gradient_clip_attr
        if clip_attr is None:
            result.append((p, g))
            continue
        g = sparse_grads.densify(p.block, p, g)
        clip_attr._process_context(context, p, g)
        if isinstance(clip_attr, GradientClipByGlobalNorm):
            global_norm_groups.setdefault(clip_attr.group_name, clip_attr)
            result.append((p, g))  # replaced below
        else:
            result.append(clip_attr._create_operators(p, g))

    for group_name, clip_attr in global_norm_groups.items():
        sq_vars = context[group_name]
        pairs = context[group_name + "_pairs"]
        block = sq_vars[0].block
        gsum = block.create_var(
            name=unique_name.generate("global_norm_sq"), shape=(1,),
            dtype="float32")
        block.append_op(type="sum", inputs={"X": [v.name for v in sq_vars]},
                        outputs={"Out": [gsum.name]},
                        attrs={OpRole.KEY: OpRole.Backward})
        gnorm = block.create_var(
            name=unique_name.generate("global_norm"), shape=(1,),
            dtype="float32")
        block.append_op(type="sqrt", inputs={"X": [gsum.name]},
                        outputs={"Out": [gnorm.name]},
                        attrs={OpRole.KEY: OpRole.Backward})
        maxnorm = block.create_var(
            name=unique_name.generate("global_norm_max"), shape=(1,),
            dtype="float32")
        block.append_op(type="clip", inputs={"X": [gnorm.name]},
                        outputs={"Out": [maxnorm.name]},
                        attrs={"min": clip_attr.clip_norm, "max": 1e30,
                               OpRole.KEY: OpRole.Backward})
        const = block.create_var(
            name=unique_name.generate("global_norm_const"), shape=(1,),
            dtype="float32")
        block.append_op(type="fill_constant",
                        outputs={"Out": [const.name]},
                        attrs={"shape": [1], "value": clip_attr.clip_norm,
                               "dtype": "float32",
                               OpRole.KEY: OpRole.Backward})
        # factor = clip_norm / max(global_norm, clip_norm)
        scale = block.create_var(
            name=unique_name.generate("global_norm_scale"), shape=(1,),
            dtype="float32")
        block.append_op(type="elementwise_div",
                        inputs={"X": [const.name], "Y": [maxnorm.name]},
                        outputs={"Out": [scale.name]},
                        attrs={OpRole.KEY: OpRole.Backward})
        new_result = []
        pair_map = {p.name: (p, g) for p, g in pairs}
        for p, g in result:
            if p.name in pair_map and g is not None:
                out = g.block.create_var(name=g.name + "@GCLIP",
                                         shape=p.shape, dtype=p.dtype)
                g.block.append_op(
                    type="elementwise_mul",
                    inputs={"X": [g.name], "Y": [scale.name]},
                    outputs={"Out": [out.name]},
                    attrs={OpRole.KEY: OpRole.Backward})
                new_result.append((p, out))
            else:
                new_result.append((p, g))
        result = new_result
    return result
