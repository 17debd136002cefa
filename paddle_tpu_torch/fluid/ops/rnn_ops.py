"""The ``recurrent`` op: a StaticRNN / DynamicRNN step block run over time.

The port's counterpart of ``paddle_tpu/fluid/ops/rnn_ops.py``'s
``recurrent`` (the rest of that module waits for ROADMAP Queue 1 item 4).
Where the JAX lowering runs the step ops inside one ``lax.scan``, this one
runs them eagerly in a Python loop over T on an env of their own; the
executor tapes the whole loop under autograd like any forward op, and the
op's ``grad_of`` takes its gradient (reference: recurrent_op.cc with its
StepScopes).

- inputs: StepInputs (each [B, T, ...]), Boot (the memories' first
  values), Params (what the step block reads from outside), Length (an
  optional [B]: a row's memory stops changing after its length).
- attrs: sub_ops_desc (the step ops' dicts), step_vars, param_names,
  mem_prev, mem_new, step_out_inner, reverse (run from T - 1 down to 0).
- outputs: Out (each step output stacked to [B, T, ...]), FinalState.

The step context is keyless, as the JAX lowering's is: a random op of the
step block draws from a generator seeded with its seed (0 too), the same
draw at every time step and in every run.
"""
import torch

from .registry import (register_lowering, OpProxy, lower_op_list,
                       LoweringContext)
from .common import one, many


@register_lowering("recurrent")
def _recurrent(ctx, inputs, attrs):
    xs_parent = many(inputs, "StepInputs")
    boot = many(inputs, "Boot")
    params = many(inputs, "Params")
    length = one(inputs, "Length")
    sub_ops = [OpProxy(d) for d in attrs["sub_ops_desc"]]
    step_vars = attrs["step_vars"]
    mem_new = attrs["mem_new"]
    out_inner = attrs["step_out_inner"]
    n_steps = xs_parent[0].shape[1] if xs_parent else attrs["max_len"]
    times = range(n_steps)
    if attrs.get("reverse", False):
        times = reversed(times)
    lens = None if length is None else length.reshape(-1)
    sub_ctx = LoweringContext(ctx.device, is_test=ctx.is_test,
                              block_runner=ctx.block_runner)
    sub_ctx.keyless = True
    base_env = dict(zip(attrs["param_names"], params))
    carry, ys = list(boot), [None] * n_steps
    for t in times:
        env = dict(base_env)
        env.update(zip(step_vars, (x[:, t] for x in xs_parent)))
        env.update(zip(attrs["mem_prev"], carry))
        lower_op_list(sub_ops, env, sub_ctx)
        new_carry = []
        for prev, name in zip(carry, mem_new):
            nv = env[name]
            if lens is not None:
                # the JAX lowering's blend, so the gradients split as its do
                mask = (t < lens).to(nv.dtype)
                mask = mask.reshape((-1,) + (1,) * (nv.dim() - 1))
                nv = mask * nv + (1 - mask) * prev
            new_carry.append(nv)
        carry = new_carry
        ys[t] = [env[n] for n in out_inner]
    return {"Out": [torch.stack([y[j] for y in ys], dim=1)
                    for j in range(len(out_inner))],
            "FinalState": carry}
