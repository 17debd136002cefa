"""One training step of a convolutional model in the JAX package and in the
port, on the CPU, for tests/test_torch_resnet.py,
tests/test_torch_resnet_bf16.py, tests/test_torch_mlp_vgg.py and
tests/test_torch_se_resnext_step.py (and ``signature``, a program as
comparable data, for the new model tests).

Models (``MODELS``): resnet_imagenet(depth=50) at 3x64x64 (batch 4: the
last stage normalizes 4 * 2 * 2 = 16 values a channel) and
resnet_cifar10(depth=8) at 3x32x32 (batch 4), each with Momentum(0.01,
0.9), as bench.py's ResNet-50 leg trains; vgg16 (cifar10's 3x32x32) and
se_resnext(layers=50) (3x32x32) at batch 16, each with Adam(1e-3), as
benchmark/fluid_benchmark.py trains them: every batch_norm normalizes at
least 16 values a channel (VGG's after fc1 the batch's, SE-ResNeXt's last
stage 16 * 1 * 1). All with 10 classes. Their dropout ops are set to drop
nothing (``dropout_prob`` 0 on both sides: the two packages draw from
different generators). Parameters, running
statistics and optimizer state come from one package's startup program
(the JAX package's, but the port's for SE-ResNeXt-50) and reach the port
by params_from_numpy; inputs come from seeded numpy.

``op_by_op`` runs the port's plan of a step (taped forwards, batch_norm_grad
paired with its forward's statistics, the optimizer ops as one group) op by
op on the values the JAX executor computed for each op's inputs ("teacher
forcing"), so that the amplification of rounding through fifty layers does
not hide an op's error. ``e2e_errors`` compares the port executor's whole
step with the JAX executor's.

For a float32 value that cancels to rounding noise (a batch norm's scale
gradient), ``jax_float64_errors`` measures the JAX value's own error
against the JAX package's step run in float64, and ``bn_gradient_noise``
the JAX batch-norm gradients' against numpy's float64 sums on the JAX
step's inputs.
"""
import collections
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import models as jmodels
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.fluid.core_types import to_torch_dtype
from paddle_tpu_torch.fluid.interop import tensor_from_numpy
from paddle_tpu_torch.fluid.ops import grad_ops, registry

# image shape, batch, model module, network function and its keywords, the
# optimizer of each model's step, and the package whose startup program
# makes the step's first state ("port": the JAX package's startup program
# of SE-ResNeXt-50, 1,232 ops, compiles for 16 s on the CPU; the port's
# runs in under 1 s)
Model = collections.namedtuple("Model", "image batch module net kwargs "
                                        "optimizer init")
MODELS = {"resnet50": Model([3, 64, 64], 4, "resnet", "resnet_imagenet",
                            {"depth": 50}, "momentum", "jax"),
          "cifar8": Model([3, 32, 32], 4, "resnet", "resnet_cifar10",
                          {"depth": 8}, "momentum", "jax"),
          "vgg16": Model([3, 32, 32], 16, "vgg", "vgg16", {}, "adam", "jax"),
          "se_resnext50": Model([3, 32, 32], 16, "se_resnext", "se_resnext",
                                {"layers": 50}, "adam", "port")}
# the models of bench.py's ResNet leg (tests/test_torch_resnet*.py)
RESNETS = sorted(m for m in MODELS if MODELS[m].module == "resnet")
CLASSES = 10
ADAM_LR = 0.001
# op by op: each output within this share of its largest JAX magnitude
OP_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
# the op types a step's plan must run, besides its optimizer's
STEP_OPS = {"conv2d", "pool2d", "batch_norm", "batch_norm_grad", "top_k",
            "accuracy", "grad_of"}


def signature(program):
    """A program's global block as comparable data: each op's type, slots
    and attrs, and each variable's name, shape, dtype and flags."""
    b = program.global_block()
    ops = [(op.type, dict(op.inputs), dict(op.outputs),
            sorted((k, repr(v)) for k, v in op.attrs.items()))
           for op in b.ops]
    vars_ = [(v.name, v.shape, v.dtype, v.persistable, v.stop_gradient,
              type(v).__name__) for v in b.vars.values()]
    return ops, vars_


def modules(model):
    """(the JAX package's module of ``model``, the port's)."""
    name = MODELS[model].module
    return getattr(jmodels, name), getattr(tmodels, name)


def build(fluid, module, model, dtype, is_test=False):
    """(main, startup, loss, accuracy) of ``model`` in ``dtype`` as its
    module's build makes it, at MODELS' image shape and CLASSES classes,
    with its optimizer's step and every dropout op's dropout_prob 0."""
    m = MODELS[model]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=m.image, dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        x = fluid.layers.cast(img, dtype) if dtype != "float32" else img
        logits = getattr(module, m.net)(x, CLASSES, is_test=is_test,
                                        **m.kwargs)
        if dtype != "float32":
            logits = fluid.layers.cast(logits, "float32")
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        acc = fluid.layers.accuracy(input=fluid.layers.softmax(logits),
                                    label=label)
        if m.optimizer == "momentum":
            fluid.optimizer.Momentum(learning_rate=0.01,
                                     momentum=0.9).minimize(loss)
        else:
            fluid.optimizer.Adam(learning_rate=ADAM_LR).minimize(loss)
    for op in main.global_block().ops:
        if "dropout_prob" in op.attrs:
            op.attrs["dropout_prob"] = 0.0
    return main, startup, loss, acc


def feed(model, seed=0):
    m = MODELS[model]
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(m.batch, *m.image).astype("float32"),
            "label": rng.randint(0, CLASSES, (m.batch, 1)).astype("int64")}


@functools.lru_cache(maxsize=None)
def jax_step(model, dtype):
    """One JAX training step from the startup state of the model's
    ``init`` package: (the persistables before, after, every intermediate
    by name)."""
    jm, js, _, _ = build(jfluid, modules(model)[0], model, dtype)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    if MODELS[model].init == "jax":
        exe.run(js, scope=scope)
    else:
        _, ts, _, _ = build(tfluid, modules(model)[1], model, dtype)
        tscope = tfluid.Scope()
        tfluid.Executor(tfluid.CPUPlace()).run(ts, scope=tscope)
        for v in ts.global_block().vars.values():
            if v.persistable and tscope.get(v.name) is not None:
                scope.set(v.name, jnp.asarray(
                    texecutor.as_numpy(tscope.get(v.name))))
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
    tm, _, loss, acc = build(tfluid, modules(model)[1], model, dtype)
    before, after, vals = jax_step(model, dtype)
    return replay(tm, [loss.name, acc.name], feed(model), before, after,
                  vals)


def replay(tm, fetch, inputs, before, after, vals):
    """The port's plan of program ``tm`` (fetching ``fetch``) run op by op,
    each op on the JAX step's values of its inputs: the feeds ``inputs``,
    the persistables ``before`` the step (``after`` it, for an op that
    reads one after the step's last write of it: a step counter that an
    ``increment`` advanced), the intermediates ``vals``; each output
    against the JAX value (``after`` for a persistable). Returns
    [(op type, output name, max |port - jax| / max |jax|)]."""
    block = tm.global_block()
    plan = texecutor._Plan(tm, fetch)
    last_writer = {n: k for k, (op, _) in enumerate(plan.steps)
                   for n in op.output_arg_names}
    port, final = {}, set()

    def value(n):
        # a name written twice (a grad summed with a later contribution)
        # holds the port's own value until its last writer has run
        if n in port and n not in final:
            return port[n]
        meta = block.vars[n]
        if n in final and n in after:
            v = after[n]      # a persistable read after its last writer
        else:
            v = inputs.get(n, before.get(n, vals.get(n)))
        t = tensor_from_numpy(np.asarray(v)).to(to_torch_dtype(meta.dtype))
        return t.reshape(()) if meta.shape == () else t

    # a generator for dropout's snapshot, which its grad op reads back; a
    # while or conditional_block op runs its sub-block as one op
    ctx = registry.LoweringContext(
        "cpu", torch.Generator(), block_runner=texecutor._BlockRunner(tm))
    tape, errs = {}, []
    for k, (op, _) in enumerate(plan.steps):
        if k in plan.in_run:
            continue
        run = plan.runs.get(k, (k,))
        ops = [plan.steps[j][0] for j in run]
        for o in ops:
            registry.fold_const(o, ctx)
        env = {n: value(n) for o in ops for n in o.input_arg_names
               if n != "@EMPTY@"}
        if len(run) > 1:
            registry.lower_group(ops, env, ctx)
        elif k in plan.taped:
            tape[k] = grad_ops.record_forward(op, env, ctx, plan.taped[k])
        else:
            if k in plan.grad_fwd:
                ctx.record, ctx.retain_graph = plan.record_for(tape, k)
            registry.lower_op(op, env, ctx)
            ctx.record, ctx.retain_graph = None, False
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
                if not want.size:
                    continue     # an XShape output: a shape, no values
                scale = np.abs(want).max() or 1.0
                errs.append((o.type, n, np.abs(got - want).max() / scale))
    assert not tape
    return errs


def assert_op_by_op(model, dtype):
    errs = op_by_op(model, dtype)
    assert STEP_OPS | {MODELS[model].optimizer} <= {t for t, _, _ in errs}
    worst = max(errs, key=lambda e: e[2])
    assert worst[2] <= OP_TOL[dtype], worst


def port_step(model, dtype="float32", is_test=False):
    """The port's executor runs one step from the JAX startup state:
    (fetched loss and gradients by name, the persistables after, the loss's
    name)."""
    before, _, _ = jax_step(model, dtype)
    tm, ts, loss, _ = build(tfluid, modules(model)[1], model, dtype,
                            is_test)
    scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    exe.run(ts, scope=scope)
    tfluid.params_from_numpy(before, scope, "cpu")
    names = [loss.name] + [p.name + "@GRAD" for p in tm.all_parameters()
                           if p.trainable]
    got = exe.run(tm, feed=feed(model), fetch_list=names, scope=scope)
    return dict(zip(names, got)), {n: scope.get(n) for n in before}, \
        loss.name


# In the Adam models' steps a gradient below this share of the step's
# largest gradient is rounding noise (the gradient of a bias that a
# batch_norm follows is 0 by construction), so there each gradient is held
# relative to the larger of its own magnitude and this share of the
# largest. The Momentum models' gradients are held relative to their own
# magnitude alone.
GRAD_FLOOR = 1e-4


def _rel(got, want, floor=0.0):
    """(max |got - want| / max(max |want|, floor), ||got - want|| /
    max(||want||, floor * sqrt(size)))."""
    got, want = f64(got), f64(want)
    d = got - want
    return (np.abs(d).max() / (max(np.abs(want).max(), floor) or 1.0),
            np.linalg.norm(d) / (max(np.linalg.norm(want),
                                     floor * np.sqrt(want.size)) or 1.0))


# Each side computes Adam's step in float32 through about six roundings
# (the moments, lr_t's square root and quotient, the step's square root,
# quotient and product: up to 3 units of the step in the last place) and
# rounds p - step (half a unit of p): 4 units of the larger of |p| and lr
# each.
ADAM_ULPS = 8


# The Adam models' whole step: ResNet-50's limits (tests/test_torch_resnet.py),
# and no parameter off by more than the gradients' difference explains.
ADAM_E2E_LIMITS = {"loss": 5e-4, "grad_norm": 0.25, "state_norm": 0.25,
                   "adam_param_misses": 0}


def within_adam_limits(errs):
    return all(errs[k] <= lim for k, lim in ADAM_E2E_LIMITS.items())


def _adam_update(p, g, m1, m2, b1p, b2p, lr, attrs):
    """Adam's step of parameter p in float64, as the adam op computes it
    (paddle_tpu/fluid/ops/optimizer_ops.py)."""
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m1 = b1 * m1 + (1.0 - b1) * g
    m2 = b2 * m2 + (1.0 - b2) * g * g
    lr_t = lr * np.sqrt(1.0 - b2p) / (1.0 - b1p)
    return p - lr_t * m1 / (np.sqrt(m2) + eps)


def adam_param_misses(program, before, got, want, grads, jax_grads):
    """Parameter elements of one Adam step that differ from the JAX
    package's by more than the gradients' difference explains: more than
    |update(port's gradient) - update(JAX's gradient)| (Adam's update from
    ``before``, in float64) plus ADAM_ULPS float32 units in the last place
    of the larger of |p| and lr, for the roundings of the two sides.
    Adam's update is lr * g / (|g| + eps / sqrt(1 - beta2)) at the first
    step, so a gradient within rounding of eps / sqrt(1 - beta2) (3.2e-7)
    or of 0 moves its parameter's update by a large share of lr. ``got`` and
    ``want``: the parameters after the step by name; ``grads`` and
    ``jax_grads``: each parameter's gradient by name. Returns {parameter:
    count}."""
    misses = {}
    for op in program.global_block().ops:
        if op.type != "adam":
            continue
        p = op.input("Param")[0]
        state = [f64(before[op.input(slot)[0]]) for slot in
                 ("Param", "Moment1", "Moment2", "Beta1Pow", "Beta2Pow",
                  "LearningRate")]
        lr = float(state[-1].reshape(-1)[0])
        b1p, b2p = (float(x.reshape(-1)[0]) for x in state[3:5])
        jg = f64(jax_grads[op.input("Grad")[0]])
        tg = f64(grads[op.input("Grad")[0]]).reshape(jg.shape)
        explained = np.abs(
            _adam_update(state[0], tg, state[1], state[2], b1p, b2p, lr,
                         op.attrs) -
            _adam_update(state[0], jg, state[1], state[2], b1p, b2p, lr,
                         op.attrs))
        w = f64(want[p])
        ulp = np.spacing(np.maximum(np.abs(w), lr).astype(np.float32))
        d = np.abs(f64(got[p]).reshape(w.shape) - w)
        misses[p] = int((d > explained + ADAM_ULPS * ulp).sum())
    return misses


def e2e_errors(model, fetched, state, loss, dtype="float32"):
    """The port's step against the JAX executor's: the loss relative, the
    worst gradient (with Adam relative to GRAD_FLOOR of the largest at
    least) and the worst persistable after the step (velocities or
    moments, running statistics, and with Momentum the parameters), each by
    max and by norm.
    With Adam the moments are held relative to the gradient floor carried
    through them ((1 - beta1) g and (1 - beta2) g^2), and the parameters,
    which Adam's update moves by a large share of lr where a gradient is
    within rounding of 0 or of eps / sqrt(1 - beta2), by
    ``adam_param_misses`` (their total count)."""
    before, after, vals = jax_step(model, dtype)
    errs = {"loss": abs(float(fetched[loss]) - float(vals[loss])) /
            abs(float(vals[loss]))}
    grads = {n: g for n, g in fetched.items() if n != loss}
    floor, floors = 0.0, dict.fromkeys(after, 0.0)
    if MODELS[model].optimizer == "adam":
        floor = GRAD_FLOOR * max(np.abs(f64(vals[n])).max() for n in grads)
        program = build(tfluid, modules(model)[1], model, dtype)[0]
        misses = adam_param_misses(program, before, state, after, grads,
                                   vals)
        errs["adam_param_misses"] = sum(misses.values())
        floors = {n: 0.1 * floor if "_moment1_acc_" in n else
                  0.001 * floor ** 2 if "_moment2_acc_" in n else 0.0
                  for n in after if n not in misses}
    for key, rels in (("grad", [_rel(g, vals[n], floor)
                                for n, g in grads.items()]),
                      ("state", [_rel(state[n], after[n], f)
                                 for n, f in floors.items()])):
        errs[key + "_max"] = max(r[0] for r in rels)
        errs[key + "_norm"] = max(r[1] for r in rels)
    return errs


# ---- float64 references ----------------------------------------------------

def wide(program):
    """A clone of `program` with every float32 variable, and every float32
    dtype attr (fill_constant's, cast's), float64."""
    out = program.clone()
    block = out.global_block()
    for v in block.vars.values():
        if v.dtype == "float32":
            v.dtype = "float64"
    for op in block.ops:
        for k, v in op.attrs.items():
            if k.endswith("dtype") and v == "float32":
                op.attrs[k] = "float64"
    return out


@contextlib.contextmanager
def float64():
    """x64 on, and ``jnp.float32`` read as ``jnp.float64``, for the JAX
    runs inside alone: the JAX lowerings cast to ``jnp.float32`` where
    they want float32 or wider (batch_norm's statistics, the softmax
    cross-entropy), which in a float64 run means float64.
    ``jax_enable_x64`` is not set globally: it would reach the later test
    files of the same worker."""
    f32 = jnp.float32
    jnp.float32 = jnp.float64
    try:
        with jax.enable_x64(True):
            yield
    finally:
        jnp.float32 = f32


def _wide_scope(state):
    """A JAX scope holding `state`, float32 values widened to float64 (run
    it with x64 on: int64 values stay int64)."""
    scope = jfluid.Scope()
    for n, v in state.items():
        v = np.asarray(v)
        scope.set(n, v.astype(np.float64) if v.dtype == np.float32 else v)
    return scope


def rel(want, ref):
    """max |want - ref| / max |want|."""
    want, ref = f64(want), f64(ref)
    if not want.size:
        return 0.0
    return float(np.abs(want - ref).max() / (np.abs(want).max() or 1.0))


def jax_float64_errors(jmodel, start, steps):
    """The JAX values' own float32 error against the JAX package's program
    `jmodel.main` with every float32 variable float64 (``wide``), run under
    ``float64``: (for each step of `steps` [(feed, the JAX step's
    intermediates, the state after)] from the JAX state before it, {name:
    the JAX value's largest error relative to its largest magnitude}, every
    float intermediate and persistable; and the losses of the float64
    steps run free from `start`). Nothing of the port runs here, so that a
    fault of the port's step cannot widen its own limit."""
    wide_main = wide(jmodel.main)
    exe = jfluid.Executor(jfluid.CPUPlace())
    loss = jmodel.loss.name
    names = sorted(set(steps[0][1]) - {loss})
    state, out = start, []
    with float64():
        for feed, vals, after in steps:
            scope = _wide_scope(state)
            ref = dict(zip(names, exe.run(wide_main, feed=feed,
                                          fetch_list=names, scope=scope)))
            ref.update({n: np.asarray(scope.get(n)) for n in state})
            out.append({n: rel(vals.get(n, after.get(n)), r)
                        for n, r in ref.items()
                        if np.asarray(vals.get(n, after.get(n))).dtype.kind
                        == "f"})
            state = after
        scope = _wide_scope(start)
        losses = [float(np.asarray(exe.run(wide_main, feed=feed,
                                           fetch_list=[loss],
                                           scope=scope)[0]).reshape(-1)[0])
                  for feed, _, _ in steps]
    return out, losses


def bn_gradients(program):
    """The scale and bias gradients of the program's batch norms: sums over
    a channel that cancel to rounding noise."""
    block = program.global_block()
    return {op.input(s)[0] + "@GRAD" for op in block.ops
            if op.type == "batch_norm" for s in ("Scale", "Bias")
            if block.has_var(op.input(s)[0] + "@GRAD")}


def bn_gradient_noise(program, vals):
    """{scale or bias gradient: the JAX value's largest error, relative to
    its largest magnitude, against the gradient in float64 from the JAX
    step's own X and Y@GRAD} for each batch_norm_grad op (NCHW): the sums
    over N, H and W of dy * (x - mean) / sqrt(var + eps) and of dy, the
    batch's statistics taken in two passes, in numpy and not by the port."""
    out = {}
    for op in program.global_block().ops:
        if op.type != "batch_norm_grad":
            continue
        assert op.attr("data_layout") in (None, "NCHW")
        assert not op.attr("is_test") and not op.attr("use_global_stats")
        x = f64(vals[op.input("X")[0]])
        dy = f64(vals[op.input("Y@GRAD")[0]])
        axes = (0,) + tuple(range(2, x.ndim))
        mean = x.mean(axes, keepdims=True)
        var = np.square(x - mean).mean(axes, keepdims=True)
        eps = op.attr("epsilon")
        xhat = (x - mean) / np.sqrt(var + (1e-5 if eps is None else eps))
        for slot, ref in (("Scale@GRAD", (dy * xhat).sum(axes)),
                          ("Bias@GRAD", dy.sum(axes))):
            n = op.output(slot)[0]
            out[n] = rel(vals[n], ref)
    return out
