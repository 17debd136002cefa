"""The port's training path (append_backward, Adam.minimize, Executor.run and
run_steps) against the JAX package on the CPU, at a small size.

Both packages build the flagship Transformer's training program; the
Programs must be op-for-op identical (startup program and optimizer
accumulators included). With the JAX package's parameters and optimizer
state carried over by params_from_numpy, both executors must give the same
loss and gradients after one step and the same parameters after two
run_steps steps. Inputs come from seeded numpy.

Tolerances. float32: the loss to 1e-5 relative; each gradient elementwise
to 1e-4 of its largest magnitude plus 1e-7 absolute (summation order only;
the absolute term covers the k-projection biases, whose true gradient is 0:
a softmax does not see a constant added to every score of a row, so both
executors return rounding noise of ~1e-9 there). Parameters after the Adam
steps: 1e-5 absolute at lr 1e-4, where a step moves a weight by about
3e-5 and the noise gradients of the k biases move them by under 1e-6.
bfloat16: the two frameworks round bf16 products and elementwise chains at
other places (XLA keeps some intermediates in f32), which flips ReLU and
rounding boundaries through the layer: the loss to 1e-3 relative and each
gradient but the k biases' to 0.1 in the norm ||got - want|| / ||want||
(readings up to 0.052).
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import transformer as jtransformer
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.fluid.ops import registry
from paddle_tpu_torch.models import transformer as ttransformer

SMALL = dict(n_layer=1, d_model=128, n_head=2, d_ff=256, seq_len=16,
             src_vocab=64, tgt_vocab=64, dropout_rate=0.0)
LR = 1e-4


def _build(fluid, transformer, **cfg):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, loss = transformer.build(**dict(SMALL, **cfg))
        fluid.optimizer.Adam(learning_rate=LR).minimize(loss)
    return main, startup, loss


def _signature(program):
    b = program.global_block()
    ops = [(op.type, dict(op.inputs), dict(op.outputs),
            sorted((k, repr(v)) for k, v in op.attrs.items()))
           for op in b.ops]
    vars_ = [(v.name, v.shape, v.dtype, v.persistable, v.stop_gradient,
              type(v).__name__) for v in b.vars.values()]
    return ops, vars_


@pytest.mark.parametrize("cfg", [{}, {"dtype": "bfloat16"},
                                 {"use_fused_attention": False},
                                 {"dropout_rate": 0.1}],
                         ids=["f32", "bf16", "unfused", "dropout"])
def test_training_programs_are_op_for_op_identical(cfg):
    jm, js, _ = _build(jfluid, jtransformer, **cfg)
    tm, ts, _ = _build(tfluid, ttransformer, **cfg)
    for jp, tp in ((jm, tm), (js, ts)):
        jops, jvars = _signature(jp)
        tops, tvars = _signature(tp)
        assert len(jops) == len(tops)
        for a, b in zip(jops, tops):
            assert a == b
        assert jvars == tvars
    types = [op.type for op in tm.global_block().ops]
    assert types.count("adam") == len(tm.all_parameters())
    assert "grad_of" in types and "softmax_with_cross_entropy_grad" in types
    accs = {v.name for v in tm.global_block().vars.values()
            if v.persistable and "_acc_" in v.name}
    assert "enc.0.attn.q.w_moment1_acc_0" in accs
    assert "src_emb_beta2_pow_acc_acc_0" in accs


def test_training_programs_helper_is_the_bench_training_leg():
    cfg = {k: v for k, v in SMALL.items()}
    with tfluid.unique_name.guard():
        main, startup, loss = ttransformer.training_programs(7, **cfg)
    tm, ts, tloss = _build(tfluid, ttransformer)
    assert startup.random_seed == 7 and loss.name == tloss.name
    assert _signature(main) == _signature(tm)
    assert _signature(startup) == _signature(ts)


def _state_names(program):
    return [v.name for v in program.global_block().vars.values()
            if v.persistable]


def _pair(cfg):
    """Both packages' programs, startups run, and the JAX package's whole
    state (parameters, moments, beta powers, learning rate) carried into the
    port's scope."""
    jm, js, jloss = _build(jfluid, jtransformer, **cfg)
    tm, ts, tloss = _build(tfluid, ttransformer, **cfg)
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    texe.run(ts, scope=tscope)
    names = [n for n in _state_names(jm) if jscope.get(n) is not None]
    tfluid.params_from_numpy({n: np.asarray(jscope.get(n)) for n in names},
                             tscope, "cpu")
    return (jm, jexe, jscope, jloss), (tm, texe, tscope, tloss), names


def _f32(x):
    return np.asarray(texecutor.as_numpy(x), dtype=np.float32)


def _one_step(cfg):
    j, t, _ = _pair(cfg)
    batch = jtransformer.synthetic_batch(2, SMALL["seq_len"],
                                         dict(SMALL, **cfg)["tgt_vocab"], 0)
    grads = [p.name + "@GRAD" for p in j[0].all_parameters()]
    want = j[1].run(j[0], feed=batch, fetch_list=[j[3].name] + grads,
                    scope=j[2])
    got = t[1].run(t[0], feed=batch, fetch_list=[t[3].name] + grads,
                   scope=t[2])
    return grads, [_f32(w) for w in want], [_f32(g) for g in got]


def test_one_step_loss_and_gradients_match_jax_executor():
    _assert_f32_step_agrees(*_one_step({}))


def _assert_f32_step_agrees(grads, want, got):
    """The f32 tolerances of the module docstring."""
    assert got[0].shape == () and abs(got[0] - want[0]) <= 1e-5 * want[0]
    for name, w, g in zip(grads, want[1:], got[1:]):
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max() + 1e-7, name


# the CE gate needs V % 128 == 0
KERNEL_VOCAB = dict(src_vocab=128, tgt_vocab=128)


@pytest.mark.parametrize("emb_impl", ["scatter", "segsum"])
def test_flags_on_step_matches_jax_executor(monkeypatch, emb_impl):
    """One f32 training step with FLAGS_ce_kernel, FLAGS_ln_kernel and
    FLAGS_emb_grad_kernel on, in both packages: the port's gates forced on
    for CPU tensors (its wrappers then run the kernels' plain versions), the
    JAX package's Pallas kernels in interpret mode with its attention kept
    on the dense mode (its kernel switch is shared with the attention
    dispatch). Loss and every gradient match the JAX step and the port's
    flags-off step at the flags-off test's tolerances, and each kernel
    wrapper runs as often as on the card (1 CE forward, 1 CE backward, one
    LN backward per layer_norm op, one embedding grad per table)."""
    from paddle_tpu.ops import attention as jattention
    from paddle_tpu.ops import ce_kernel as jce
    from paddle_tpu.ops import emb_grad_kernel as jeg
    from paddle_tpu.ops import layernorm_kernel as jln
    from paddle_tpu_torch.fluid.ops import common
    from paddle_tpu_torch.ops import ce_kernel as tce
    from paddle_tpu_torch.ops import emb_grad_kernel as teg
    from paddle_tpu_torch.ops import layernorm_kernel as tln
    grads, off_want, off = _one_step(KERNEL_VOCAB)
    _assert_f32_step_agrees(grads, off_want, off)

    calls = {}
    for mod, name in ((tce, "ce_forward"), (tce, "ce_backward"),
                      (tln, "ln_backward"), (teg, "emb_grad")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    monkeypatch.setattr(common, "on_card", lambda x: x.device.type == "cpu")
    for mod, name in ((jce, "ce_forward"), (jce, "ce_backward"),
                      (jln, "ln_backward"), (jeg, "emb_grad")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, **k:
                            _r(*a, **dict(k, interpret=True)))
    monkeypatch.setattr(jattention, "_use_pallas", lambda: True)
    monkeypatch.setattr(jattention, "_bthd_mode",
                        lambda q, k: jattention._MODE_DENSE)
    for flag, value in (("ce_kernel", "1"), ("ln_kernel", "1"),
                        ("emb_grad_kernel", emb_impl),
                        ("adam_kernel", "0")):      # JAX Adam off the TPU
        monkeypatch.setenv("FLAGS_" + flag, value)
    grads, want, got = _one_step(KERNEL_VOCAB)
    n_ln = 5 * SMALL["n_layer"]          # 2 per encoder, 3 per decoder layer
    assert calls == {"ce_forward": 1, "ce_backward": 1, "ln_backward": n_ln,
                     "emb_grad": 2}
    _assert_f32_step_agrees(grads, want, got)
    _assert_f32_step_agrees(grads, off, got)


def test_bf16_step_matches_within_stated_tolerance():
    grads, want, got = _one_step({"dtype": "bfloat16"})
    assert abs(got[0] - want[0]) <= 1e-3 * want[0]
    for name, w, g in zip(grads, want[1:], got[1:]):
        if ".k.b@" in name:
            continue        # true gradient 0: both are rounding noise
        assert np.linalg.norm(g - w) <= 0.1 * np.linalg.norm(w), name


def test_two_run_steps_match_jax_parameters():
    j, t, names = _pair({})
    steps = [jtransformer.synthetic_batch(2, SMALL["seq_len"],
                                          SMALL["tgt_vocab"], seed)
             for seed in (1, 2)]
    stacked = {n: np.stack([s[n] for s in steps]) for n in steps[0]}
    want, = j[1].run_steps(j[0], feed=stacked, n_steps=2,
                           fetch_list=[j[3].name], scope=j[2])
    got, = t[1].run_steps(t[0], feed=stacked, n_steps=2,
                          fetch_list=[t[3].name], scope=t[2])
    assert got.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    params = {p.name for p in j[0].all_parameters()}
    for n in names:
        w, g = _f32(j[2].get(n)), _f32(t[2].get(n))
        if n in params:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=n)
        elif "pow_acc" in n:      # beta powers: b^3 after startup + 2 steps
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=n)


def _dropout_program(p, n=4096):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[n], dtype="float32",
                               stop_gradient=False)
        y = tfluid.layers.dropout(
            x, dropout_prob=p, dropout_implementation="upscale_in_train")
        loss = tfluid.layers.mean(y)
        tfluid.backward.append_backward(loss)
    return main, x, y


@pytest.mark.parametrize("save_mask", [False, True])
def test_dropout_invariants(monkeypatch, save_mask):
    """The kept share is near 1 - i/256 (p quantized to i/256); dX is zero
    exactly where the forward output is; kept elements are scaled by 1 /
    the realized keep probability, in both directions. The mask is redrawn
    from the generator snapshot (default) or kept (FLAGS_dropout_save_mask),
    and the forward op is tagged for the redraw only in the first case."""
    if save_mask:
        monkeypatch.setenv("FLAGS_dropout_save_mask", "1")
    p, n = 0.3, 4096
    main, x, y = _dropout_program(p, n)
    fwd = [op for op in main.global_block().ops if op.type == "dropout"][0]
    assert ("rng_tag" in fwd.attrs) == (not save_mask)
    xv = np.random.RandomState(0).uniform(1.0, 2.0, (3, n)).astype("float32")
    out, dx = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed={"x": xv}, fetch_list=[y, x.name + "@GRAD"],
        scope=tfluid.Scope())
    keep_p = 1.0 - round(p * 256) / 256.0
    kept = out != 0
    share = kept.mean()
    sigma = np.sqrt(keep_p * (1 - keep_p) / kept.size)
    assert abs(share - keep_p) < 5 * sigma
    assert np.array_equal(dx != 0, kept)
    np.testing.assert_array_equal(out[kept], (xv / np.float32(keep_p))[kept])
    dout = np.float32(1.0 / xv.size)
    np.testing.assert_allclose(dx[kept], dout / np.float32(keep_p),
                               rtol=1e-6)


def test_dropout_grad_without_its_forward_raises():
    ctx = registry.LoweringContext("cpu", torch.Generator())
    with pytest.raises(RuntimeError, match="FLAGS_dropout_save_mask"):
        registry.get_lowering("dropout_grad")(
            ctx, {"Out@GRAD": [torch.ones(4)], "Mask": [None]},
            {"dropout_prob": 0.5, "rng_tag": "y",
             "dropout_implementation": "upscale_in_train"})


def test_each_forward_op_runs_once_in_a_training_step(monkeypatch):
    """grad_of takes its gradient from the taped forward op: every forward
    lowering runs once per step, not twice as a literal vjp would."""
    tm, ts, tloss = _build(tfluid, ttransformer)
    calls = {}
    for op_type in ("mul", "fused_attention", "layer_norm"):
        fn = registry.get_lowering(op_type)

        def counted(ctx, inputs, attrs, _fn=fn, _t=op_type):
            calls[_t] = calls.get(_t, 0) + 1
            return _fn(ctx, inputs, attrs)
        monkeypatch.setitem(registry._LOWERINGS, op_type, counted)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(ts, scope=scope)
    batch = jtransformer.synthetic_batch(2, SMALL["seq_len"],
                                         SMALL["tgt_vocab"], 0)
    exe.run(tm, feed=batch, fetch_list=[tloss], scope=scope)
    ops = tm.global_block().ops
    for op_type in calls:
        assert calls[op_type] == sum(op.type == op_type for op in ops)
    plan = exe._plan(tm, [tloss.name])
    assert len(plan.taped) == len(plan.grad_fwd) == \
        sum(op.type == "grad_of" for op in ops)


def test_plan_keeps_the_forward_op_of_a_grad_op():
    """With no fetch at all the training step still runs: the loss's mean
    op is kept because grad_of(mean) needs its record."""
    tm, ts, tloss = _build(tfluid, ttransformer)
    plan = texecutor._Plan(tm, [])
    kept = [op for op, _ in plan.steps]
    assert any(op.type == "mean" for op in kept)
    assert len(kept) == len(tm.global_block().ops)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(ts, scope=scope)
    before = scope.get("proj.w").clone()
    exe.run(tm, feed=jtransformer.synthetic_batch(2, SMALL["seq_len"],
                                                  SMALL["tgt_vocab"], 0),
            scope=scope)
    assert not torch.equal(before, scope.get("proj.w"))


def test_grad_of_without_a_forward_record_raises():
    ctx = registry.LoweringContext("cpu")
    with pytest.raises(RuntimeError, match="no forward record"):
        registry.get_lowering("grad_of")(ctx, {}, {"fwd_type": "mul"})


def test_run_steps_rejects_an_unstacked_feed():
    tm, ts, tloss = _build(tfluid, ttransformer)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(ts, scope=scope)
    batch = jtransformer.synthetic_batch(2, SMALL["seq_len"],
                                         SMALL["tgt_vocab"], 0)
    with pytest.raises(ValueError, match="stacked"):
        exe.run_steps(tm, feed=batch, n_steps=3, fetch_list=[tloss],
                      scope=scope)


def test_run_steps_refuses_host_ops(monkeypatch):
    tm, ts, tloss = _build(tfluid, ttransformer)
    monkeypatch.setattr(registry, "_HOST_OPS", {"mean"})
    exe = tfluid.Executor(tfluid.CPUPlace())
    with pytest.raises(NotImplementedError, match="host op"):
        exe.run_steps(tm, feed={}, n_steps=1, fetch_list=[tloss],
                      scope=tfluid.Scope())


def test_run_steps_fetches_state_per_step():
    """A fetched parameter comes back once per step, as it was after that
    step (the fused update writes parameters in place)."""
    tm, ts, tloss = _build(tfluid, ttransformer)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(ts, scope=scope)
    one = jtransformer.synthetic_batch(2, SMALL["seq_len"],
                                       SMALL["tgt_vocab"], 0)
    stacked = {n: np.stack([v] * 3) for n, v in one.items()}
    losses, w = exe.run_steps(tm, feed=stacked, n_steps=3,
                              fetch_list=[tloss, "proj.b"], scope=scope)
    assert losses.shape == (3,) and w.shape == (3, SMALL["tgt_vocab"])
    assert not np.array_equal(w[0], w[1]) and not np.array_equal(w[1], w[2])
    np.testing.assert_array_equal(w[2], scope.get("proj.b").numpy())
    assert losses[2] < losses[0]
