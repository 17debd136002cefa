"""The port's optimizers (paddle_tpu_torch.fluid.optimizer) and fused Adam
update (paddle_tpu_torch/ops/adam_kernel.py) against the JAX package on the
CPU.

On the CPU the Adam wrapper runs its plain version, which these tests hold
to the Pallas kernel run in interpret mode at tests/test_adam_kernel.py's
shapes and tolerance: the moments to rtol 1e-5 and atol 1e-7 (the Pallas
kernel's FMA association moves their last bits), p bit for bit in bf16 and
to 1e-5 relative in f32. Programs with SGD, weight decay and gradient
clipping must be op-for-op the JAX package's and give the same parameters
after two steps (float32, summation order only: 1e-5 relative plus 1e-7).
Inputs come from seeded numpy.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.ops import adam_kernel as JK
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.ops import adam_kernel as TK

B1, B2, EPS = 0.9, 0.999, 1e-8


def _bf16_to_torch(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("shape,dtype", [((512, 512), "bfloat16"),
                                         ((16, 256), "float32"),
                                         ((64, 2048), "bfloat16")])
def test_adam_plain_matches_pallas_interpret(shape, dtype):
    rng = np.random.RandomState(0)
    jdt = getattr(jnp, dtype)
    p = jnp.asarray(rng.randn(*shape), jdt)
    g = jnp.asarray(rng.randn(*shape), jdt)
    m1 = rng.randn(*shape).astype("float32") * 0.1
    m2 = np.abs(rng.randn(*shape)).astype("float32") * 0.1
    want = JK.adam_update(p, g, jnp.asarray(m1), jnp.asarray(m2),
                          jnp.float32(0.003), B1, B2, EPS, interpret=True)
    conv = _bf16_to_torch if dtype == "bfloat16" else \
        (lambda a: torch.from_numpy(np.array(a)))
    tp, tg = conv(p), conv(g)
    before = TK.adam_update.launches
    got = TK.adam_update(tp, tg, torch.from_numpy(m1.copy()),
                         torch.from_numpy(m2.copy()), torch.tensor(0.003),
                         B1, B2, EPS)
    assert TK.adam_update.launches == before          # no kernel on the CPU
    assert got[0] is tp                               # in place
    assert got[0].dtype == getattr(torch, dtype)
    for i in (1, 2):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=1e-5, atol=1e-7)
    gp, wp = got[0].float().numpy(), np.asarray(want[0], np.float32)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(gp, wp)
    else:
        np.testing.assert_allclose(gp, wp, rtol=1e-5, atol=0)


@pytest.mark.parametrize("shape", [(512,), (7, 128), (8, 100), (8, 128),
                                   (8192, 512), (512, 8192), (512, 2048),
                                   (2048, 512), (8, 131072), (24, 384)])
def test_adam_ok_is_the_jax_rule(shape):
    assert TK.adam_ok(shape) == JK.adam_ok(shape)


def test_adam_wrapper_never_falls_back_off_the_cpu():
    x = torch.empty(8, 128, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        TK.adam_update(x, x, x, x, torch.empty((), device="meta"),
                       B1, B2, EPS)


def test_adam_kernel_source_names_its_pallas_kernel():
    from paddle_tpu_torch.ops import _build
    src = open(os.path.join(_build._CSRC, "adam.cu")).read()
    for sym in ("adam_update", "paddle_tpu/ops/adam_kernel.py:53", "Hopper"):
        assert sym in src


def _mlp(fl, opt, clip=None, param_regularizer=None):
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[6], dtype="float32")
        h = fl.layers.fc(input=x, size=5, act="relu",
                         param_attr=fl.ParamAttr(
                             name="h.w", regularizer=param_regularizer))
        y = fl.layers.fc(input=h, size=3, param_attr=fl.ParamAttr(name="y.w"))
        loss = fl.layers.mean(fl.layers.scale(y, scale=0.5))
        if clip is not None:
            fl.clip.set_gradient_clip(clip(fl), param_list=["h.w", "y.w"],
                                      program=main)
        opt(fl).minimize(loss)
    return main, startup, loss


def _signature(program):
    return [(op.type, dict(op.inputs), dict(op.outputs),
             sorted((k, repr(v)) for k, v in op.attrs.items()))
            for op in program.global_block().ops]


OPTIMIZERS = {
    "sgd": (lambda fl: fl.optimizer.SGD(0.1), None, None),
    "sgd_l2": (lambda fl: fl.optimizer.SGD(
        0.1, regularization=fl.regularizer.L2Decay(0.01)), None, None),
    "sgd_l1_param": (lambda fl: fl.optimizer.SGD(0.1), None,
                     lambda fl: fl.regularizer.L1Decay(0.02)),
    "sgd_clip_value": (lambda fl: fl.optimizer.SGD(0.1),
                       lambda fl: fl.clip.GradientClipByValue(0.05), None),
    "sgd_clip_norm": (lambda fl: fl.optimizer.SGD(0.1),
                      lambda fl: fl.clip.GradientClipByNorm(0.1), None),
    "adam_clip_global_norm": (
        lambda fl: fl.optimizer.Adam(0.01),
        lambda fl: fl.clip.GradientClipByGlobalNorm(0.1), None),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_programs_and_updates_match_jax(name):
    opt, clip, reg = OPTIMIZERS[name]
    j = _mlp(jfluid, opt, clip, reg and reg(jfluid))
    t = _mlp(tfluid, opt, clip, reg and reg(tfluid))
    for jp, tp in zip(j[:2], t[:2]):
        assert _signature(jp) == _signature(tp)
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    jexe.run(j[1], scope=jscope)
    texe.run(t[1], scope=tscope)
    names = [v.name for v in j[0].global_block().vars.values()
             if v.persistable and jscope.get(v.name) is not None]
    tfluid.params_from_numpy({n: np.asarray(jscope.get(n)) for n in names},
                             tscope, "cpu")
    rng = np.random.RandomState(3)
    for _ in range(2):
        x = rng.randn(4, 6).astype("float32")
        want, = jexe.run(j[0], feed={"x": x}, fetch_list=[j[2]], scope=jscope)
        got, = texe.run(t[0], feed={"x": x}, fetch_list=[t[2]], scope=tscope)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    for n in names:
        np.testing.assert_allclose(tscope.get(n).numpy(),
                                   np.asarray(jscope.get(n)), rtol=1e-5,
                                   atol=1e-7, err_msg=n)


def test_params_from_numpy_carries_optimizer_state():
    """A model trained a step by the JAX package continues in the port: the
    moments and beta powers carry over under the same names with the
    parameters, and the next step agrees."""
    opt = lambda fl: fl.optimizer.Adam(0.01)
    j, t = _mlp(jfluid, opt), _mlp(tfluid, opt)
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    jexe.run(j[1], scope=jscope)
    texe.run(t[1], scope=tscope)
    rng = np.random.RandomState(4)
    jexe.run(j[0], feed={"x": rng.randn(4, 6).astype("float32")},
             scope=jscope)
    state = {v.name: np.asarray(jscope.get(v.name))
             for v in j[0].global_block().vars.values()
             if v.persistable and jscope.get(v.name) is not None}
    assert {"h.w_moment1_acc_0", "h.w_moment2_acc_0",
            "h.w_beta1_pow_acc_acc_0", "y.w_beta2_pow_acc_acc_0"} <= \
        set(state)
    assert abs(float(state["h.w_beta1_pow_acc_acc_0"][0]) - B1 ** 2) < 1e-6
    tfluid.params_from_numpy(state, tscope, "cpu")
    for n, v in state.items():
        np.testing.assert_array_equal(tscope.get(n).numpy(), v)
    x = rng.randn(4, 6).astype("float32")
    jexe.run(j[0], feed={"x": x}, scope=jscope)
    texe.run(t[0], feed={"x": x}, scope=tscope)
    for n in state:
        np.testing.assert_allclose(tscope.get(n).numpy(),
                                   np.asarray(jscope.get(n)), rtol=1e-5,
                                   atol=1e-7, err_msg=n)


def test_adam_lowering_takes_the_kernel_only_on_the_card(monkeypatch):
    """The adam op's dispatch: FLAGS_adam_kernel on, a CUDA tensor and
    adam_ok(shape); the plain update otherwise (the CPU here)."""
    from paddle_tpu_torch.fluid.ops import optimizer_ops
    p = torch.zeros(8, 128)
    assert not optimizer_ops._adam_kernel_ok(p)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda s: True))
    assert optimizer_ops._adam_kernel_ok(p)
    assert not optimizer_ops._adam_kernel_ok(torch.zeros(128))
    monkeypatch.setenv("FLAGS_adam_kernel", "0")
    assert not optimizer_ops._adam_kernel_ok(p)


# --------------------------------------------------------------------------
# the multi-tensor Adam kernel and the executor's adam runs
# --------------------------------------------------------------------------

# a mix of the flagship's admitted shapes (small), both dtypes, and a shape
# the kernel takes that adam_ok does not (odd sizes: the kernel's ragged end)
MULTI_MIX = [((64, 128), "bfloat16"), ((16, 256), "float32"),
             ((8, 384), "bfloat16"), ((7, 3), "float32"), ((13,), "bfloat16")]


def _multi_inputs(seed):
    rng = np.random.RandomState(seed)
    out = []
    for i, (shape, dtype) in enumerate(MULTI_MIX):
        jdt = getattr(jnp, dtype)
        out.append((jnp.asarray(rng.randn(*shape), jdt),
                    jnp.asarray(rng.randn(*shape), jdt),
                    rng.randn(*shape).astype("float32") * 0.1,
                    np.abs(rng.randn(*shape)).astype("float32") * 0.1,
                    np.float32(0.003 * (i + 1))))
    return out


def _to_torch(a):
    if a.dtype == jnp.bfloat16:
        return _bf16_to_torch(a)
    return torch.from_numpy(np.array(a))


def test_adam_multi_plain_is_per_parameter_and_matches_pallas():
    """adam_update_multi on CPU tensors runs its plain version in place: bit
    for bit adam_update_plain on each parameter, each with its own lr_t, and
    the Pallas kernel's update (interpret mode) at the tolerances above."""
    params = _multi_inputs(5)
    ps, gs, m1s, m2s, lrs = ([_to_torch(x[0]) for x in params],
                             [_to_torch(x[1]) for x in params],
                             [torch.from_numpy(x[2].copy()) for x in params],
                             [torch.from_numpy(x[3].copy()) for x in params],
                             [torch.tensor([x[4]]) for x in params])
    want = [TK.adam_update_plain(p, g, a, b, lr, B1, B2, EPS)
            for p, g, a, b, lr in zip(ps, gs, m1s, m2s, lrs)]
    assert all(torch.equal(x, y) for w, v in zip(
        want, TK.adam_update_multi_plain(ps, gs, m1s, m2s, lrs, B1, B2, EPS))
        for x, y in zip(w, v))
    before = TK.adam_update_multi.launches
    got = TK.adam_update_multi(ps, gs, m1s, m2s, lrs, B1, B2, EPS)
    assert TK.adam_update_multi.launches == before     # no kernel on the CPU
    assert got[0] is ps and got[1] is m1s and got[2] is m2s   # in place
    for w, p, m1, m2 in zip(want, ps, m1s, m2s):
        for x, y in zip(w, (p, m1, m2)):
            assert x.dtype == y.dtype and torch.equal(x, y)
    for (p, g, m1, m2, lr), tp, tm1, tm2, (shape, dtype) in zip(
            params, ps, m1s, m2s, MULTI_MIX):
        if len(shape) != 2 or shape[0] % 8 or shape[1] % 128:
            continue            # the Pallas kernel takes adam_ok's shapes
        jw = JK.adam_update(p, g, jnp.asarray(m1), jnp.asarray(m2),
                            jnp.float32(lr), B1, B2, EPS, interpret=True)
        for i, t in ((1, tm1), (2, tm2)):
            np.testing.assert_allclose(t.numpy(), np.asarray(jw[i]),
                                       rtol=1e-5, atol=1e-7)
        gp, wp = tp.float().numpy(), np.asarray(jw[0], np.float32)
        if dtype == "bfloat16":
            np.testing.assert_array_equal(gp, wp)
        else:
            np.testing.assert_allclose(gp, wp, rtol=1e-5, atol=0)


def test_adam_multi_wrapper_never_falls_back_off_the_cpu():
    x = torch.empty(8, 128, device="meta")
    lr = torch.empty(1, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        TK.adam_update_multi([x, x], [x, x], [x, x], [x, x], [lr, lr],
                             B1, B2, EPS)


def _adam_ops(program):
    return [op for op in program.global_block().ops if op.type == "adam"]


def test_plan_groups_the_flagship_adam_ops_into_one_run():
    """bench.py's training program (the flagship Transformer with
    Adam(1e-4)) ends in one adam op per parameter: the executor's plan runs
    them as one group, which holds the 67 parameters adam_ok admits (one
    kernel launch on the card) and the others (the plain update)."""
    from paddle_tpu_torch.fluid import executor as texecutor
    from paddle_tpu_torch.models import transformer as ttransformer
    main, _, loss = ttransformer.training_programs(
        1234, **ttransformer.FLAGSHIP_CFG)
    plan = texecutor._Plan(main, [loss.name])
    kept = [op for op, _ in plan.steps]
    adam = [k for k, op in enumerate(kept) if op.type == "adam"]
    assert len(adam) == len(_adam_ops(main)) == len(main.all_parameters())
    assert list(plan.runs.values()) == [adam]
    shapes = [main.global_block().vars[kept[k].input("Param")[0]].shape
              for k in adam]
    assert sum(TK.adam_ok(s) for s in shapes) == 67


def test_plan_splits_a_run_where_an_adam_op_reads_another_s_output():
    """Two adam ops where the second reads what the first writes (here a
    shared Beta1Pow accumulator) stay in separate runs; so does an op with
    other betas."""
    from paddle_tpu_torch.fluid import executor as texecutor
    main, _, loss = _mlp(tfluid, lambda fl: fl.optimizer.Adam(0.01))
    ops = _adam_ops(main)
    assert len(ops) == 4
    plan = texecutor._Plan(main, [loss.name])
    assert len(plan.runs) == 1 and len(list(plan.runs.values())[0]) == 4
    dep = main.clone()
    dops = _adam_ops(dep)
    dops[2].inputs["Beta1Pow"] = list(dops[1].output("Beta1PowOut"))
    dops[3].attrs["beta2"] = 0.99
    plan = texecutor._Plan(dep, [loss.name])
    assert [[plan.steps[k][0] for k in run]
            for run in plan.runs.values()] == [dops[:2]]


def test_adam_group_sends_the_admitted_parameters_to_one_call(monkeypatch):
    """With the kernel's gate forced on for CPU tensors, a training step of
    a small Transformer hands every admitted parameter to one
    adam_update_multi call (its plain version here), the others to the
    plain update, and the parameters after two steps still match the JAX
    executor's (1e-5 absolute at lr 1e-4, as test_torch_backward.py)."""
    from paddle_tpu.models import transformer as jtransformer
    from paddle_tpu_torch.fluid.ops import optimizer_ops
    from paddle_tpu_torch.models import transformer as ttransformer
    cfg = dict(n_layer=1, d_model=128, n_head=2, d_ff=256, seq_len=16,
               src_vocab=64, tgt_vocab=64, dropout_rate=0.0)

    def build(fl, tr):
        main, startup = fl.Program(), fl.Program()
        with fl.unique_name.guard(), fl.program_guard(main, startup):
            _, loss = tr.build(**cfg)
            fl.optimizer.Adam(learning_rate=1e-4).minimize(loss)
        return main, startup, loss

    jm, js, jloss = build(jfluid, jtransformer)
    tm, ts, tloss = build(tfluid, ttransformer)
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    texe.run(ts, scope=tscope)
    names = [v.name for v in jm.global_block().vars.values()
             if v.persistable and jscope.get(v.name) is not None]
    tfluid.params_from_numpy({n: np.asarray(jscope.get(n)) for n in names},
                             tscope, "cpu")
    calls = []
    real = TK.adam_update_multi
    monkeypatch.setattr(TK, "adam_update_multi",
                        lambda ps, *a: calls.append(len(ps)) or real(ps, *a))
    monkeypatch.setattr(optimizer_ops, "_adam_kernel_ok",
                        lambda p: TK.adam_ok(p.shape))
    admitted = sum(TK.adam_ok(p.shape) for p in tm.all_parameters())
    assert 0 < admitted < len(tm.all_parameters())
    for seed in range(2):
        batch = jtransformer.synthetic_batch(2, cfg["seq_len"],
                                             cfg["tgt_vocab"], seed)
        jexe.run(jm, feed=batch, fetch_list=[jloss], scope=jscope)
        texe.run(tm, feed=batch, fetch_list=[tloss], scope=tscope)
    assert calls == [admitted, admitted]
    for n in names:
        np.testing.assert_allclose(tscope.get(n).numpy(),
                                   np.asarray(jscope.get(n)), rtol=0,
                                   atol=1e-5, err_msg=n)


def test_adam_multi_wrapper_refuses_a_list_across_devices():
    """A list that starts on the CPU must lie on the CPU throughout: the
    plain version never runs on a tensor off the CPU."""
    x = torch.zeros(8, 128)
    meta = torch.empty(8, 128, device="meta")
    lr = torch.zeros(1)
    with pytest.raises(ValueError, match="all be on the CPU"):
        TK.adam_update_multi([x, meta], [x, x], [x, x], [x, x], [lr, lr],
                             B1, B2, EPS)
