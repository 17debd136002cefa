"""StaticRNN, DynamicRNN and the book's RNN encoder-decoder on the port
against the JAX package, on the CPU.

Each program is built by both packages from the same code and is op for
op the JAX package's in every block, its ``recurrent`` op carrying the
same step ops. Both executors run it from the JAX startup state (carried
by ``params_from_numpy``): the outputs and the gradients of the inputs,
the boot memory and the step weights agree within 1e-5 of their largest
JAX magnitude plus 1e-7 (float32), with a Length vector (a row's memory
stops at its length, through the JAX lowering's blend ``mask * new + (1 -
mask) * prev``, so a gradient splits at the mask as the JAX package's
does), with ``reverse`` and on DynamicRNN over padded input.

A StaticRNN step block has no step key in the JAX package (its scan body
is traced once, with the keyless context), so a dropout there keeps one
mask at every time step and in every run; the port's keyless step
context draws the same way.

The book's rnn_encoder_decoder (tools/torch_control_flow_programs.py at
the book test's widths) trains 30 steps in lockstep with the JAX executor,
each from the JAX executor's state before it: every op of the port's plan
on the JAX step's values of its inputs (a ``recurrent`` op counts as one)
within 1e-4 of its largest JAX output (the repo's float32 op limit), the
loss within 1e-5 relative, Adam's parameters off by no more than the two
gradients' difference explains. Its inference artifact is byte for byte
the JAX package's, and each package serves the other's within 1e-5.
"""
import importlib.util
import os

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid

import torch_resnet_step as step
from test_torch_control_flow import Both, assert_close, programs, _names

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "torch_control_flow_programs",
    os.path.join(ROOT, "tools", "torch_control_flow_programs.py"))
tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tool)

B, T, D, H = 3, 4, 5, 6
LOSS_TOL = 1e-5
LOCKSTEP_STEPS = 30


def _rnn(fluid, length=False, reverse=False, boot=False, dynamic=False):
    """A tanh RNN (fc over [x_t, h]) over x [B, T, D] with a second step
    output h * x_t[:, :1]; the loss is the mean of both stacked outputs
    plus the final state's; the gradients of x, the boot and every
    parameter are appended."""
    L = fluid.layers
    x = L.data(name="x", shape=[T, D], dtype="float32")
    x.stop_gradient = False
    h0 = L.data(name="h0", shape=[H], dtype="float32")
    h0.stop_gradient = False
    lens = L.data(name="lens", shape=[1], dtype="int64") if length else None
    if dynamic:
        rnn = L.DynamicRNN()
        with rnn.block():
            xt = rnn.step_input(x)
            h = rnn.memory(init=h0)
            nh = L.fc(input=[xt, h], size=H, act="tanh")
            rnn.update_memory(h, nh)
            rnn.output(nh, L.elementwise_mul(nh, L.slice(
                xt, axes=[1], starts=[0], ends=[1]), axis=0))
    else:
        rnn = L.StaticRNN(length=lens)
        with rnn.step():
            xt = rnn.step_input(x)
            h = rnn.memory(init=h0) if boot else \
                rnn.memory(None, [-1, H], xt, 0.0)
            nh = L.fc(input=[xt, h], size=H, act="tanh")
            rnn.update_memory(h, nh)
            rnn.output(nh, L.elementwise_mul(nh, L.slice(
                xt, axes=[1], starts=[0], ends=[1]), axis=0))
    out, side = rnn()
    block = fluid.default_main_program().global_block()
    rec = [op for op in block.ops if op.type == "recurrent"][0]
    if reverse:
        rec.attrs["reverse"] = True
    final = block.var(rec.output("FinalState")[0])
    loss = L.elementwise_add(L.elementwise_add(L.mean(out), L.mean(side)),
                             L.mean(final))
    params = [p.name for p in fluid.default_main_program().all_parameters()]
    wrt = [x, h0] + [block.var(p) for p in params]
    grads = fluid.backward.gradients(loss, wrt)
    return [out, side, final, loss] + [g for g in grads if g is not None]


def _feed(seed=0, length=False):
    rng = np.random.RandomState(seed)
    feed = {"x": rng.uniform(-1, 1, (B, T, D)).astype("float32"),
            "h0": rng.uniform(-1, 1, (B, H)).astype("float32")}
    if length:
        feed["lens"] = np.array([[T], [2], [1]], dtype="int64")
    return feed


@pytest.mark.parametrize("kind", ["plain", "boot", "length", "reverse",
                                  "length_reverse", "dynamic"])
def test_rnn_forward_and_gradients_match_jax(kind):
    length = "length" in kind
    both = Both(lambda fl: _rnn(fl, length=length,
                                reverse="reverse" in kind,
                                boot=kind != "plain",
                                dynamic=kind == "dynamic"))
    main = both.t[0]
    assert [op.type for op in main.global_block().ops].count(
        "recurrent") == 1
    assert any(op.type == "grad_of" and op.attrs["fwd_type"] == "recurrent"
               for op in main.global_block().ops)
    got = both.run(_feed(length=length))
    out, final = got[0], got[2]
    if length:
        # a row's memory changes only at the steps before its length: the
        # final state is the output of its last step (1 for the row of
        # length 2), or of step 0 when the RNN runs from T - 1 down
        for row, n in ((1, 2), (2, 1)):
            t = 0 if "reverse" in kind else n - 1
            np.testing.assert_array_equal(final[row], out[row, t])


def _rnn_dropout(fluid):
    """A StaticRNN whose step applies dropout(0.5) to a step of ones."""
    L = fluid.layers
    x = L.data(name="x", shape=[T, 64], dtype="float32")
    rnn = L.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        h = rnn.memory(None, [-1, 64], xt, 0.0)
        d = L.dropout(xt, 0.5)
        rnn.update_memory(h, L.elementwise_add(h, d))
        rnn.output(d)
    return [rnn()]


def test_static_rnn_step_draws_one_fixed_mask():
    """The step block's dropout keeps one mask at every time step and in
    every run, in both packages (a keyless step context)."""
    feed = {"x": np.ones((B, T, 64), dtype="float32")}
    for fluid in (jfluid, tfluid):
        main, startup, fetch = programs(fluid, _rnn_dropout)
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        runs = [np.asarray(exe.run(main, feed=feed, fetch_list=_names(fetch),
                                   scope=scope)[0]) for _ in range(2)]
        out = runs[0]
        assert 0.3 < (out != 0).mean() < 0.7
        for t in range(1, T):
            np.testing.assert_array_equal(out[:, t], out[:, 0])
        np.testing.assert_array_equal(runs[1], runs[0])


# --------------------------------------------------------------------------
# the book's rnn_encoder_decoder
# --------------------------------------------------------------------------

def _state(scope, program):
    return {v.name: np.asarray(scope.get(v.name))
            for v in program.global_block().vars.values()
            if v.persistable and scope.get(v.name) is not None}


def _models():
    j = tool.rnn_encoder_decoder(jfluid, **tool.ENC_DEC_NARROW)
    t = tool.rnn_encoder_decoder(tfluid, **tool.ENC_DEC_NARROW)
    return j, t


def test_encoder_decoder_is_op_for_op_the_jax_packages():
    from test_torch_control_flow import signature
    j, t = _models()
    assert signature(j.main) == signature(t.main)
    assert signature(j.startup) == signature(t.startup)
    ops = [op.type for op in t.main.global_block().ops]
    assert ops.count("recurrent") == 2 and ops.count("adam") == 10
    assert [op.type for op in t.main.block(1).ops] == \
        ["mul", "mul", "sum", "elementwise_add", "tanh"]


def test_encoder_decoder_trains_in_lockstep_with_jax_executor():
    j, t = _models()
    jexe, texe = jfluid.Executor(jfluid.CPUPlace()), \
        tfluid.Executor(tfluid.CPUPlace())
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe.run(j.startup, scope=jscope)
    texe.run(t.startup, scope=tscope)
    block = t.main.global_block()
    inter = sorted({n for op in block.ops for n in op.output_arg_names
                    if n != "@EMPTY@" and not block.var(n).persistable})
    adam = sorted(op.input("Param")[0] for op in block.ops
                  if op.type == "adam")
    grads = [p + "@GRAD" for p in adam]
    feed = tool.enc_dec_batch(10, **tool.ENC_DEC_NARROW)
    losses, worst = [], 0.0
    for _ in range(LOCKSTEP_STEPS):
        state = _state(jscope, j.main)
        tfluid.params_from_numpy(state, tscope, "cpu")
        vals = dict(zip(inter, (np.asarray(v) for v in jexe.run(
            j.main, feed=feed, fetch_list=inter, scope=jscope))))
        after = _state(jscope, j.main)
        errs = step.replay(t.main, [t.loss.name], feed, state, after, vals)
        assert "recurrent" in {e[0] for e in errs}
        worst = max(worst, max(e[2] for e in errs))
        got = texe.run(t.main, feed=feed, fetch_list=[t.loss.name] + grads,
                       scope=tscope)
        want = float(vals[t.loss.name])
        assert abs(float(got[0]) - want) <= LOSS_TOL * abs(want)
        got_after = {n: tscope.get(n).numpy() for n in after}
        misses = step.adam_param_misses(
            t.main, state, got_after, after, dict(zip(grads, got[1:])),
            {g: vals[g] for g in grads})
        assert sum(misses.values()) == 0, misses
        losses.append(want)
    assert worst <= step.OP_TOL["float32"]
    assert losses[-1] < losses[0] * 0.8


def _tree(d):
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            with open(os.path.join(root, n), "rb") as f:
                out[os.path.relpath(os.path.join(root, n), d)] = f.read()
    return out


def _serve(fluid, dirname, feed):
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        prog, feeds, fetches = fluid.io.load_inference_model(dirname, exe)
        assert sorted(feeds) == ["src", "tgt"]
        return np.asarray(exe.run(prog, feed=feed, scope=scope)[0])


def test_encoder_decoder_artifact_is_the_jax_packages_and_each_serves_the_others(
        tmp_path):
    j, t = _models()
    jexe, texe = jfluid.Executor(jfluid.CPUPlace()), \
        tfluid.Executor(tfluid.CPUPlace())
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe.run(j.startup, scope=jscope)
    texe.run(t.startup, scope=tscope)
    tfluid.params_from_numpy(_state(jscope, j.main), tscope, "cpu")
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    with jfluid.scope_guard(jscope):
        jfluid.io.save_inference_model(jdir, j.feeds, [j.out], jexe,
                                       main_program=j.main)
    with tfluid.scope_guard(tscope):
        tfluid.io.save_inference_model(tdir, t.feeds, [t.out], texe,
                                       main_program=t.main)
    jtree, ttree = _tree(jdir), _tree(tdir)
    assert sorted(jtree) == sorted(ttree)
    for rel in jtree:
        assert ttree[rel] == jtree[rel], rel
    batch = tool.enc_dec_batch(3, **tool.ENC_DEC_NARROW)
    feed = {"src": batch["src"][:2], "tgt": batch["tgt"][:2]}
    want = _serve(jfluid, jdir, feed)
    V, S = tool.ENC_DEC_NARROW["vocab"], tool.ENC_DEC_NARROW["seq"]
    assert want.shape == (2, S, V)
    assert_close(_serve(tfluid, jdir, feed), want)
    assert_close(_serve(jfluid, tdir, feed), want)
