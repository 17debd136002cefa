"""Op lowering registry. Importing this package registers every ported op's
PyTorch lowering."""
from .registry import (register_lowering, get_lowering, has_lowering,
                       register_grad_maker, get_grad_maker, has_grad_maker,
                       mark_no_grad, is_no_grad, is_host_op,
                       LoweringContext, infer_outputs)

from . import math_ops        # noqa: F401
from . import activation_ops  # noqa: F401
from . import tensor_ops      # noqa: F401
from . import reduce_ops      # noqa: F401
from . import loss_ops        # noqa: F401
from . import metric_ops      # noqa: F401
from . import nn_ops          # noqa: F401
from . import optimizer_ops   # noqa: F401
from . import grad_ops        # noqa: F401

__all__ = ["register_lowering", "get_lowering", "has_lowering",
           "register_grad_maker", "get_grad_maker", "has_grad_maker",
           "mark_no_grad", "is_no_grad", "is_host_op",
           "LoweringContext", "infer_outputs"]
