"""Magnitude pruning (the port's counterpart of
``paddle_tpu/fluid/contrib/slim/prune.py``; reference: fluid/contrib/slim/
prune/ — PruneStrategy zeroes the smallest-|w| fraction of each parameter
and reapplies the masks after each optimizer step, so that pruned weights
stay dead).

The masks are numpy arrays, built on the host from each parameter's value
as the JAX package builds them (so the same weights give the same masks);
``apply_masks`` multiplies each parameter by its mask on the parameter's
device, the mask copied there on each call."""
import numpy as np
import torch

__all__ = ["prune_parameters", "apply_masks", "sparsity", "PruneStrategy"]


def _param_names(program, params=None):
    from ...framework import Parameter
    block = program.global_block()
    names = []
    for var in block.vars.values():
        if isinstance(var, Parameter) and len(var.shape or []) >= 2:
            if params is None or var.name in params:
                names.append(var.name)
    return names


def prune_parameters(program, scope, ratio, params=None):
    """Zero the smallest-|w| `ratio` fraction of each (>= 2-D) parameter.
    Returns {name: mask ndarray}."""
    from ...executor import as_numpy
    masks = {}
    for name in _param_names(program, params):
        w = scope.get(name)
        if w is None:
            continue
        a = as_numpy(w).astype("float32")
        k = int(a.size * ratio)
        if k <= 0:
            masks[name] = np.ones_like(a)
            continue
        # zero exactly the k smallest |w| (a threshold over-prunes where
        # many values tie, e.g. constant initializers)
        idx = np.argpartition(np.abs(a).reshape(-1), k - 1)[:k]
        mask = np.ones(a.size, a.dtype)
        mask[idx] = 0.0
        mask = mask.reshape(a.shape)
        scope.set(name, _masked(w, mask))
        masks[name] = mask
    return masks


def _masked(w, mask):
    """w * mask on w's device, in w's dtype."""
    return w * torch.from_numpy(mask).to(device=w.device, dtype=w.dtype)


def apply_masks(scope, masks):
    """Re-zero pruned weights (call after each optimizer step)."""
    for name, mask in masks.items():
        w = scope.get(name)
        if w is not None:
            scope.set(name, _masked(w, mask))


def sparsity(scope, masks):
    total = live = 0
    for name, mask in masks.items():
        total += mask.size
        live += int(mask.sum())
    return 1.0 - live / max(total, 1)


class PruneStrategy(object):
    """Compressor strategy: ramp sparsity linearly from start_epoch to
    end_epoch (one-shot when end_epoch is None) and keep the masks applied
    every step. `pruner` overrides the mask maker: callable (program,
    scope, ratio, params) -> {name: mask} (reference PruneStrategy and
    Pruner)."""

    def __init__(self, pruner=None, start_epoch=0, end_epoch=None,
                 target_ratio=0.5, params=None):
        self.pruner = pruner or prune_parameters
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.ratio = target_ratio
        self.params = params
        self.masks = None

    def _ratio_at(self, epoch):
        if self.end_epoch is None or self.end_epoch <= self.start_epoch:
            return self.ratio
        frac = min(1.0, (epoch - self.start_epoch + 1.0) /
                   (self.end_epoch - self.start_epoch))
        return self.ratio * frac

    def on_epoch_begin(self, context):
        epoch = context["epoch"]
        if epoch < self.start_epoch:
            return
        ramping = self.end_epoch is not None and epoch <= self.end_epoch
        if self.masks is None or ramping:
            self.masks = self.pruner(
                context["program"], context["scope"],
                self._ratio_at(epoch), self.params)

    def on_batch_end(self, context):
        if self.masks:
            apply_masks(context["scope"], self.masks)
