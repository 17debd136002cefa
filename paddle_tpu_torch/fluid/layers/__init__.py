"""fluid.layers — the user-facing layer functions ported so far, exported
in the JAX package's order (a later module's name wins)."""
from . import math_op_patch  # noqa: F401
from .nn import *          # noqa: F401,F403
from .tensor import *      # noqa: F401,F403
from .ops import *         # noqa: F401,F403
from .io import *          # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .metric_op import *   # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403

from . import nn
from . import tensor
from . import ops
from . import io
from . import control_flow
from . import metric_op
from . import learning_rate_scheduler
