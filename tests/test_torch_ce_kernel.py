"""The port's cross-entropy kernels (paddle_tpu_torch/ops/ce_kernel.py)
against the JAX package's Pallas kernels in interpret mode, and the
softmax_with_cross_entropy lowering and its grad with the kernel route
forced on for CPU tensors, against the JAX lowerings.

On the CPU the wrappers run their plain versions, which keep the kernels'
rounding points; the CUDA kernels themselves are held against the plain
versions on the card by chip_smoke.py. Inputs come from seeded numpy; bf16
inputs are rounded once and handed to both packages as the same values.

Tolerances: loss and lse (f32, sums of V exps in another order) to 1e-5
relative and 1e-5 absolute; dlogits in f32 to 1e-5 relative and 1e-7
absolute; in bf16 to 2^-7 relative (one bf16 unit in the last place: the two
round the same f32 value after a sum in another order) and 1e-7 absolute.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid.ops.registry as jregistry
from paddle_tpu.ops import attention as jattention
from paddle_tpu.ops import ce_kernel as JCE
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid.ops import common, registry
from paddle_tpu_torch.ops import ce_kernel as CE

IGNORE = -100
TOL = {"float32": (1e-5, 1e-7), "bfloat16": (2.0 ** -7, 1e-7)}


def _inputs(t, v, dtype, seed=0):
    """logits (f32 numpy holding dtype's values), labels covering ignore,
    -1, V, 0 and V-1, and dloss."""
    rng = np.random.RandomState(seed)
    logits = (rng.randn(t, v) * 2.0).astype(np.float32)
    logits = np.asarray(jnp.asarray(logits, dtype).astype(jnp.float32))
    label = rng.randint(0, v, t).astype(np.int64)
    label[:5] = [IGNORE, -1, v, 0, v - 1]
    dloss = rng.rand(t).astype(np.float32)
    return logits, label, dloss


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t.to(getattr(torch, dtype)) if dtype else t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_ce_matches_pallas_interpret(dtype):
    t, v = 32, 256
    logits, label, dloss = _inputs(t, v, dtype)
    jl = jnp.asarray(logits, getattr(jnp, dtype))
    jloss, jlse = JCE.ce_forward(jl, jnp.asarray(label), ignore=IGNORE,
                                 interpret=True)
    jdl = JCE.ce_backward(jl, jnp.asarray(label), jlse, jnp.asarray(dloss),
                          ignore=IGNORE, interpret=True)
    tl = _t(logits, dtype)
    loss, lse = CE.ce_forward(tl, _t(label), IGNORE)
    dl = CE.ce_backward(tl, _t(label), lse, _t(dloss), IGNORE)
    assert loss.dtype == lse.dtype == torch.float32 and dl.dtype == tl.dtype
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5,
                               atol=1e-5)
    assert (loss.numpy()[:3] == 0).all() and (loss.numpy()[3:5] != 0).all()
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(dl.float().numpy(),
                               np.asarray(jdl.astype(jnp.float32)),
                               rtol=rtol, atol=atol)
    assert (dl[:3] == 0).all()
    assert CE.ce_forward.launches == 0 and CE.ce_backward.launches == 0


@pytest.mark.parametrize("t,v,itemsize", [
    (65536, 8192, 2), (65536, 8192, 4), (0, 128, 2), (8, 128, 2),
    (12, 128, 2), (16, 100, 4), (24, 384, 2), (64, 131072, 2),
    (64, 262144, 2), (8, 131072, 4), (65536, 32000, 2), (65536, 32768, 2),
    (4096, 50304, 2)])
def test_ce_ok_matches_the_jax_gate(t, v, itemsize):
    assert CE.ce_ok(t, v, itemsize) == JCE.ce_ok(t, v, itemsize)


def test_cpu_wrappers_take_the_plain_versions():
    logits, label, dloss = _inputs(16, 128, "float32", seed=1)
    tl = _t(logits)
    loss, lse = CE.ce_forward(tl, _t(label))
    want = CE.ce_forward_plain(tl, _t(label))
    assert torch.equal(loss, want[0]) and torch.equal(lse, want[1])
    assert torch.equal(CE.ce_backward(tl, _t(label), lse, _t(dloss)),
                       CE.ce_backward_plain(tl, _t(label), lse, _t(dloss)))


def _force_kernels(monkeypatch):
    """Both packages take their kernel route on the CPU: the port's gate
    sees CPU tensors as on the card (its wrappers then run the plain
    versions), the JAX package's Pallas kernels run in interpret mode.
    Returns the port's wrapper calls."""
    calls = []
    monkeypatch.setenv("FLAGS_ce_kernel", "1")
    monkeypatch.setattr(common, "on_card", lambda x: x.device.type == "cpu")
    for name in ("ce_forward", "ce_backward"):
        real = getattr(CE, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(CE, name, spy)
        jreal = getattr(JCE, name)
        monkeypatch.setattr(
            JCE, name, lambda *a, _r=jreal, **k: _r(*a, interpret=True, **k))
    monkeypatch.setattr(jattention, "_use_pallas", lambda: True)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ce_lowerings_with_the_kernel_route_match_jax(monkeypatch, dtype):
    b, s, v = 2, 8, 256
    logits, label, dloss = _inputs(b * s, v, dtype, seed=2)
    logits, label = logits.reshape(b, s, v), label.reshape(b, s, 1)
    dloss = dloss.reshape(b, s, 1)
    calls = _force_kernels(monkeypatch)
    attrs = {"soft_label": False, "ignore_index": IGNORE}
    jl = jnp.asarray(logits, getattr(jnp, dtype))
    jout = jregistry.get_lowering("softmax_with_cross_entropy")(
        None, {"Logits": [jl], "Label": [jnp.asarray(label)]}, attrs)
    jgrad = jregistry.get_lowering("softmax_with_cross_entropy_grad")(
        None, {"Logits": [jl], "Label": [jnp.asarray(label)],
               "LSE": jout["LSE"], "Loss@GRAD": [jnp.asarray(dloss)]},
        attrs)["Logits@GRAD"][0]
    ctx = registry.LoweringContext("cpu")
    tl = _t(logits, dtype)
    tout = registry.get_lowering("softmax_with_cross_entropy")(
        ctx, {"Logits": [tl], "Label": [_t(label)]}, attrs)
    tgrad = registry.get_lowering("softmax_with_cross_entropy_grad")(
        ctx, {"Logits": [tl], "Label": [_t(label)], "LSE": tout["LSE"],
              "Loss@GRAD": [_t(dloss)]}, attrs)["Logits@GRAD"][0]
    assert calls == ["ce_forward", "ce_backward"]
    for slot in ("Loss", "LSE"):
        got, want = tout[slot][0], jout[slot][0]
        assert tuple(got.shape) == want.shape == (b, s, 1)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tout["Softmax"][0].numpy(),
                               np.asarray(jout["Softmax"][0]), rtol=1e-5,
                               atol=1e-7)
    assert tgrad.dtype == tl.dtype and tuple(tgrad.shape) == (b, s, v)
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(tgrad.float().numpy(),
                               np.asarray(jgrad.astype(jnp.float32)),
                               rtol=rtol, atol=atol)


def test_ce_gate_refuses_soft_labels_and_unaligned_vocab(monkeypatch):
    from paddle_tpu_torch.fluid.ops import loss_ops
    monkeypatch.delenv("FLAGS_ce_kernel", raising=False)
    monkeypatch.setattr(common, "on_card", lambda x: x.device.type == "cpu")
    x = torch.zeros(2, 8, 256)
    assert not loss_ops._ce_kernel_ok(x, False)          # flag off
    monkeypatch.setenv("FLAGS_ce_kernel", "1")
    assert loss_ops._ce_kernel_ok(x, False)
    assert not loss_ops._ce_kernel_ok(x, True)
    assert not loss_ops._ce_kernel_ok(torch.zeros(2, 8, 200), False)
    monkeypatch.setattr(common, "on_card", lambda x: x.is_cuda)
    assert not loss_ops._ce_kernel_ok(x, False)          # CPU tensors


def _ce_program():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[256], dtype="float32")
        lab = tfluid.layers.data(name="lab", shape=[1], dtype="int64")
        loss, softmax = tfluid.layers.softmax_with_cross_entropy(
            x, lab, return_softmax=True)
        avg = tfluid.layers.mean(loss)
    return main, avg, softmax


@pytest.mark.parametrize("kernel_route", [False, True])
def test_softmax_is_computed_only_when_read(monkeypatch, kernel_route):
    """The Softmax output is skipped when nothing reads it and computed when
    it is fetched, on the plain route and on the kernel route."""
    if kernel_route:
        _force_kernels(monkeypatch)
    produced = []
    real = registry.get_lowering("softmax_with_cross_entropy")

    def spy(ctx, inputs, attrs):
        out = real(ctx, inputs, attrs)
        if ctx.device.type != "meta":       # not shape inference
            produced.append("Softmax" in out)
        return out
    monkeypatch.setitem(registry._LOWERINGS, "softmax_with_cross_entropy",
                        spy)
    main, avg, softmax = _ce_program()
    logits, label, _ = _inputs(8, 256, "float32", seed=3)
    feed = {"x": logits, "lab": label.reshape(8, 1)}
    exe = tfluid.Executor(tfluid.CPUPlace())
    loss, = exe.run(main, feed=feed, fetch_list=[avg], scope=tfluid.Scope())
    loss2, sm = exe.run(main, feed=feed, fetch_list=[avg, softmax],
                        scope=tfluid.Scope())
    assert produced == [False, True]
    assert loss == loss2
    lf = logits.astype(np.float64)
    want = np.exp(lf - lf.max(-1, keepdims=True))
    np.testing.assert_allclose(sm, want / want.sum(-1, keepdims=True),
                               rtol=1e-5, atol=1e-7)


def test_training_step_never_computes_softmax(monkeypatch):
    from paddle_tpu_torch.models import transformer as ttransformer
    produced = []
    real = registry.get_lowering("softmax_with_cross_entropy")

    def spy(ctx, inputs, attrs):
        out = real(ctx, inputs, attrs)
        if ctx.device.type != "meta":       # not shape inference
            produced.append("Softmax" in out)
        return out
    monkeypatch.setitem(registry._LOWERINGS, "softmax_with_cross_entropy",
                        spy)
    cfg = dict(n_layer=1, d_model=128, n_head=2, d_ff=256, seq_len=16,
               src_vocab=64, tgt_vocab=64, dropout_rate=0.0)
    with tfluid.unique_name.guard():
        main, startup, loss = ttransformer.training_programs(0, **cfg)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=ttransformer.synthetic_batch(2, 16, 64, 0),
            fetch_list=[loss], scope=scope)
    assert produced == [False]


def test_kernel_source_names_its_pallas_kernels():
    """csrc/ce.cu says which Pallas kernels it replaces, and its entry
    points are the ones the build binds."""
    import os
    from paddle_tpu_torch.ops import _build
    src = open(os.path.join(_build._CSRC, "ce.cu")).read()
    for sym in ("ce_forward", "ce_backward", "Hopper",
                "paddle_tpu/ops/ce_kernel.py:60",
                "paddle_tpu/ops/ce_kernel.py:72"):
        assert sym in src
    assert [fn for fn, _ in _build.SIGNATURES["ce"]] == ["ce_forward",
                                                         "ce_backward"]
