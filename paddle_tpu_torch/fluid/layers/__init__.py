"""fluid.layers — the user-facing layer functions ported so far."""
from . import math_op_patch  # noqa: F401
from .nn import *          # noqa: F401,F403
from .tensor import *      # noqa: F401,F403
from .io import *          # noqa: F401,F403
from .metric_op import *   # noqa: F401,F403

from . import nn
from . import tensor
from . import io
from . import metric_op
