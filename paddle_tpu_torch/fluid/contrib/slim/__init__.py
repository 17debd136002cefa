"""fluid.contrib.slim (the port's counterpart of the JAX package's): the
Compressor, magnitude pruning and teacher-student distillation."""
from .core.compressor import Compressor
from . import prune
from . import distillation
from .prune import PruneStrategy, prune_parameters, apply_masks, sparsity
from .distillation import merge, fsp_loss, l2_loss, soft_label_loss

__all__ = ["Compressor", "prune", "distillation", "PruneStrategy",
           "prune_parameters", "apply_masks", "sparsity", "merge",
           "fsp_loss", "l2_loss", "soft_label_loss"]
