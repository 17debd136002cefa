"""Op lowering registry. Importing this package registers every ported op's
PyTorch lowering."""
from .registry import (register_lowering, get_lowering, has_lowering,
                       LoweringContext, infer_outputs)

from . import math_ops        # noqa: F401
from . import activation_ops  # noqa: F401
from . import tensor_ops      # noqa: F401
from . import reduce_ops      # noqa: F401
from . import loss_ops        # noqa: F401
from . import nn_ops          # noqa: F401

__all__ = ["register_lowering", "get_lowering", "has_lowering",
           "LoweringContext", "infer_outputs"]
