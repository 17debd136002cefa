"""paddle_tpu_torch.fluid — the Fluid front-end on PyTorch: Program IR built by
fluid.layers, trained through append_backward and fluid.optimizer, run by an
Executor on one torch.device (the card by default), saved, loaded and served
through fluid.io, fluid.transpiler and fluid.inference."""
from . import core_types
from . import unique_name
from . import framework
from .framework import (Program, Variable, Parameter, Operator, Block,
                        default_main_program, default_startup_program,
                        program_guard, CPUPlace, CUDAPlace,
                        cpu_places, cuda_places)
from .core_types import VarType, OpRole

from . import ops  # registers all op lowerings
from . import initializer
from .param_attr import ParamAttr
from . import layers
from .layer_helper import LayerHelper
from . import backward
from .backward import append_backward
from . import optimizer
from . import regularizer
from . import clip
from .clip import (GradientClipByValue, GradientClipByNorm,
                   GradientClipByGlobalNorm, set_gradient_clip)
from .executor import Executor, Scope, global_scope, scope_guard
from .interop import params_from_numpy
from . import io
from .io import save_vars, save_params, save_persistables, load_vars, \
    load_params, load_persistables, save_inference_model, load_inference_model
from . import transpiler
from .transpiler import memory_optimize, release_memory
from . import inference

__all__ = framework.__all__ + [
    "ops", "initializer", "ParamAttr", "layers", "LayerHelper", "backward",
    "append_backward", "optimizer", "regularizer", "clip",
    "GradientClipByValue", "GradientClipByNorm", "GradientClipByGlobalNorm",
    "set_gradient_clip",
    "Executor", "Scope", "global_scope", "scope_guard", "params_from_numpy",
    "io", "save_vars", "save_params", "save_persistables", "load_vars",
    "load_params", "load_persistables", "save_inference_model",
    "load_inference_model", "transpiler", "memory_optimize",
    "release_memory", "inference",
]
