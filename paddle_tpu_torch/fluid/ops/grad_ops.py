"""The generic gradient op ``grad_of``: one lowering serves every forward op
that has no grad maker of its own.

The port's counterpart of ``paddle_tpu/fluid/ops/grad_ops.py``, with the
same program-level protocol (built by backward.py):

  inputs:  "FWD_IN:<slot>"  the forward op's inputs, slot by slot
           "OG:<slot>"      the gradient of each forward output ("@EMPTY@"
                            where none flows back: treated as 0)
  outputs: "IG:<slot>"      the gradient of each forward input ("@EMPTY@"
                            where none is needed)
  attrs:   fwd_type, fwd_attrs, need_grad {slot: [bool per var]}

The JAX lowering re-runs the forward under ``jax.vjp`` and relies on XLA to
merge the recomputed forward with the real one. Eager PyTorch merges
nothing, so the port never runs a forward twice: the executor pairs each
``grad_of`` with its forward op when it plans a run, runs that forward op
under autograd on detached leaves of the inputs that need a gradient
(``record_forward``), and hands the record to the ``grad_of`` lowering,
which calls ``torch.autograd.grad`` once and so frees the saved residuals.
"""
import contextlib

import torch

from .registry import register_lowering, get_lowering, write_outputs

EMPTY_VAR = "@EMPTY@"


class ForwardRecord(object):
    """A taped forward op: the leaves ((slot, index), tensor) its grad is
    taken with respect to, and its outputs {slot: [tensor]}."""

    __slots__ = ("leaves", "outs")

    def __init__(self, leaves, outs):
        self.leaves = leaves
        self.outs = outs


def record_forward(op, env, ctx, need_grad):
    """Run forward op ``op`` under autograd, its inputs flagged in
    ``need_grad`` ({slot: [bool]}) replaced by detached leaves; write its
    outputs into env and return the ForwardRecord. With no input flagged
    (the forward op of a paired grad op) it runs without autograd and the
    record keeps only its outputs."""
    inputs, leaves = {}, []
    for slot, names in op.inputs.items():
        flags = need_grad.get(slot, ())
        vals = []
        for i, n in enumerate(names):
            v = None if n == EMPTY_VAR else env[n]
            if v is not None and i < len(flags) and flags[i]:
                v = v.detach().requires_grad_(True)
                leaves.append(((slot, i), v))
            vals.append(v)
        inputs[slot] = vals
    # no leaf (a paired grad op's forward): no graph, only the outputs
    with torch.enable_grad() if leaves else contextlib.nullcontext():
        outs = get_lowering(op.type)(ctx, inputs, op.attrs)
    write_outputs(op, outs, env)
    return ForwardRecord(leaves, outs)


@register_lowering("grad_of", no_grad=True)
def _grad_of(ctx, inputs, attrs):
    rec = ctx.record
    if rec is None:
        raise RuntimeError(
            "grad_of(%s): no forward record; the executor pairs each grad_of "
            "with its forward op in the same run" % attrs["fwd_type"])
    fwd_len = {k[len("FWD_IN:"):]: len(v) for k, v in inputs.items()
               if k.startswith("FWD_IN:")}
    og = {k[len("OG:"):]: v for k, v in inputs.items() if k.startswith("OG:")}
    outs, cots = [], []
    for slot, vals in rec.outs.items():
        slot_og = og.get(slot)
        for i, o in enumerate(vals):
            g = slot_og[i] if slot_og and i < len(slot_og) else None
            if g is None or o is None or not o.requires_grad:
                continue     # no cotangent: contributes zero
            outs.append(o)
            cots.append(torch.broadcast_to(g, o.shape).to(o.dtype))
    leaves = [leaf for _, leaf in rec.leaves]
    grads = torch.autograd.grad(outs, leaves, cots, allow_unused=True) \
        if outs else [None] * len(leaves)
    result = {}
    for ((slot, i), leaf), g in zip(rec.leaves, grads):
        key = "IG:" + slot
        if key not in result:
            result[key] = [None] * fwd_len[slot]
        result[key][i] = torch.zeros_like(leaf) if g is None else g
    return result
