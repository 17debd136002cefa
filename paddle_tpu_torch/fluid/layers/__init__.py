"""fluid.layers — the user-facing layer functions ported so far."""
from .nn import *          # noqa: F401,F403
from .io import *          # noqa: F401,F403

from . import nn
from . import io
