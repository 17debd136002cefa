"""One ResNet training step in the JAX package and in the port, on the CPU,
for tests/test_torch_resnet.py and tests/test_torch_resnet_bf16.py.

Models: resnet_imagenet(depth=50) at 3x64x64 (batch 4, 10 classes: the
last stage normalizes 4 * 2 * 2 = 16 values a channel) and
resnet_cifar10(depth=8) at 3x32x32, each with Momentum(0.01, 0.9).
Parameters, running statistics and velocities are the JAX package's,
carried over by params_from_numpy; inputs come from seeded numpy.

``op_by_op`` runs the port's plan of a step (taped forwards, batch_norm_grad
paired with its forward's statistics, the momentum ops as one group) op by
op on the values the JAX executor computed for each op's inputs ("teacher
forcing"), so that the amplification of rounding through fifty layers does
not hide an op's error. ``e2e_errors`` compares the port executor's whole
step with the JAX executor's.
"""
import functools

import numpy as np

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import resnet as jresnet
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.fluid.core_types import to_torch_dtype
from paddle_tpu_torch.fluid.interop import tensor_from_numpy
from paddle_tpu_torch.fluid.ops import grad_ops, registry
from paddle_tpu_torch.models import resnet as tresnet

MODELS = {"resnet50": ([3, 64, 64], "resnet_imagenet", 50),
          "cifar8": ([3, 32, 32], "resnet_cifar10", 8)}
BATCH, CLASSES = 4, 10
# op by op: each output within this share of its largest JAX magnitude
OP_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
# the op types a step's plan must run
STEP_OPS = {"conv2d", "pool2d", "batch_norm", "batch_norm_grad", "momentum",
            "top_k", "accuracy", "grad_of"}


def build(fluid, resnet, model, dtype, is_test=False):
    """(main, startup, loss, accuracy) of ``model`` in ``dtype`` as
    resnet.build makes it, at MODELS' image shape and CLASSES classes."""
    image, net, depth = MODELS[model]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=image, dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        x = fluid.layers.cast(img, dtype) if dtype != "float32" else img
        logits = getattr(resnet, net)(x, CLASSES, depth=depth,
                                      is_test=is_test)
        if dtype != "float32":
            logits = fluid.layers.cast(logits, "float32")
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        acc = fluid.layers.accuracy(input=fluid.layers.softmax(logits),
                                    label=label)
        fluid.optimizer.Momentum(learning_rate=0.01,
                                 momentum=0.9).minimize(loss)
    return main, startup, loss, acc


def feed(model, seed=0):
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(BATCH, *MODELS[model][0]).astype("float32"),
            "label": rng.randint(0, CLASSES, (BATCH, 1)).astype("int64")}


@functools.lru_cache(maxsize=None)
def jax_step(model, dtype):
    """One JAX training step from the startup state: (the persistables
    before, after, every intermediate by name)."""
    jm, js, _, _ = build(jfluid, jresnet, model, dtype)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(js, scope=scope)
    block = jm.global_block()
    before = {v.name: np.asarray(scope.get(v.name))
              for v in block.vars.values()
              if v.persistable and scope.get(v.name) is not None}
    inter = sorted({n for op in block.ops for n in op.output_arg_names
                    if n != "@EMPTY@" and not block.vars[n].persistable})
    vals = exe.run(jm, feed=feed(model), fetch_list=inter, scope=scope)
    after = {n: np.asarray(scope.get(n)) for n in before}
    return before, after, dict(zip(inter, (np.asarray(v) for v in vals)))


def f64(x):
    return np.asarray(texecutor.as_numpy(x), dtype=np.float64)


def op_by_op(model, dtype):
    """Run the port's plan of one step op by op on the JAX step's values.
    Returns [(op type, output name, max |port - jax| / max |jax|)]."""
    tm, _, loss, acc = build(tfluid, tresnet, model, dtype)
    before, after, vals = jax_step(model, dtype)
    inputs = feed(model)
    block = tm.global_block()
    plan = texecutor._Plan(tm, [loss.name, acc.name])
    last_writer = {n: k for k, (op, _) in enumerate(plan.steps)
                   for n in op.output_arg_names}
    port, final = {}, set()

    def value(n):
        # a name written twice (a grad summed with a later contribution)
        # holds the port's own value until its last writer has run
        if n in port and n not in final:
            return port[n]
        meta = block.vars[n]
        v = inputs.get(n, before.get(n, vals.get(n)))
        t = tensor_from_numpy(np.asarray(v)).to(to_torch_dtype(meta.dtype))
        return t.reshape(()) if meta.shape == () else t

    ctx = registry.LoweringContext("cpu")
    tape, errs = {}, []
    for k, (op, _) in enumerate(plan.steps):
        if k in plan.in_run:
            continue
        run = plan.runs.get(k, (k,))
        ops = [plan.steps[j][0] for j in run]
        env = {n: value(n) for o in ops for n in o.input_arg_names
               if n != "@EMPTY@"}
        if len(run) > 1:
            registry.lower_group(ops, env, ctx)
        elif k in plan.taped:
            tape[k] = grad_ops.record_forward(op, env, ctx, plan.taped[k])
        else:
            ctx.record = tape.pop(plan.grad_fwd[k]) \
                if k in plan.grad_fwd else None
            registry.lower_op(op, env, ctx)
            ctx.record = None
        for j, o in zip(run, ops):
            for n in o.output_arg_names:
                if n == "@EMPTY@" or n not in env:
                    continue
                port[n] = env[n]
                if last_writer[n] != j:
                    continue
                final.add(n)
                want = f64(after[n] if n in after else vals[n])
                got = f64(env[n]).reshape(want.shape)
                scale = np.abs(want).max() or 1.0
                errs.append((o.type, n, np.abs(got - want).max() / scale))
    assert not tape
    return errs


def assert_op_by_op(model, dtype):
    errs = op_by_op(model, dtype)
    assert STEP_OPS <= {t for t, _, _ in errs}
    worst = max(errs, key=lambda e: e[2])
    assert worst[2] <= OP_TOL[dtype], worst


def port_step(model, dtype="float32", is_test=False):
    """The port's executor runs one step from the JAX startup state:
    (fetched loss and gradients by name, the persistables after, the loss's
    name)."""
    before, _, _ = jax_step(model, dtype)
    tm, ts, loss, _ = build(tfluid, tresnet, model, dtype, is_test)
    scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    exe.run(ts, scope=scope)
    tfluid.params_from_numpy(before, scope, "cpu")
    names = [loss.name] + [p.name + "@GRAD" for p in tm.all_parameters()
                           if p.trainable]
    got = exe.run(tm, feed=feed(model), fetch_list=names, scope=scope)
    return dict(zip(names, got)), {n: scope.get(n) for n in before}, \
        loss.name


def _rel(got, want):
    """(max |got - want| / max |want|, ||got - want|| / ||want||)."""
    got, want = f64(got), f64(want)
    d = got - want
    return (np.abs(d).max() / (np.abs(want).max() or 1.0),
            np.linalg.norm(d) / (np.linalg.norm(want) or 1.0))


def e2e_errors(model, fetched, state, loss, dtype="float32"):
    """The port's step against the JAX executor's: the loss relative, and
    the worst gradient and the worst persistable after the step (parameters,
    velocities, running statistics), each by max and by norm."""
    _, after, vals = jax_step(model, dtype)
    errs = {"loss": abs(float(fetched[loss]) - float(vals[loss])) /
            abs(float(vals[loss]))}
    grads = [_rel(g, vals[n]) for n, g in fetched.items() if n != loss]
    states = [_rel(state[n], w) for n, w in after.items()]
    for key, rels in (("grad", grads), ("state", states)):
        errs[key + "_max"] = max(r[0] for r in rels)
        errs[key + "_norm"] = max(r[1] for r in rels)
    return errs
