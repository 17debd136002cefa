"""The port's LayerNorm-backward kernel (paddle_tpu_torch/ops/
layernorm_kernel.py) against the JAX package's Pallas kernel in interpret
mode, its admission rule against the JAX one, and the layer_norm op's
FLAGS_ln_kernel route (``_LnAffine``, taken through the op's ``grad_of``)
against the JAX package's ``custom_vjp`` ``_ln_affine``.

On the CPU the wrapper runs its plain version, which keeps the kernel's
formula; the CUDA kernel itself is held against the plain version on the
card by chip_smoke.py. Inputs come from seeded numpy.

Tolerances are tests/test_layernorm_kernel.py's: dx to 1e-5 in f32 and
3e-2 in bf16 (relative and absolute), dgamma and dbeta (f32 sums over the
rows) to 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.fluid.ops import nn_ops as jnn_ops
from paddle_tpu.ops import layernorm_kernel as JLN
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid.ops import common
from paddle_tpu_torch.ops import layernorm_kernel as LN

DX_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
EPS = 1e-5


def _rounded(a, dtype):
    return np.asarray(jnp.asarray(a, dtype).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_ln_backward_matches_pallas_interpret(dtype):
    rng = np.random.RandomState(0)
    r, d = 64, 256
    x = _rounded(rng.randn(r, d) * 2 + 0.3, getattr(jnp, dtype))
    dy = _rounded(rng.randn(r, d), getattr(jnp, dtype))
    gamma = rng.randn(d).astype(np.float32)
    jdx, jdg, jdb = JLN.ln_backward(jnp.asarray(x, getattr(jnp, dtype)),
                                    jnp.asarray(dy, getattr(jnp, dtype)),
                                    jnp.asarray(gamma), EPS, interpret=True)
    tdt = getattr(torch, dtype)
    dx, dg, db = LN.ln_backward(torch.tensor(x).to(tdt),
                                torch.tensor(dy).to(tdt),
                                torch.tensor(gamma), EPS)
    assert dx.dtype == tdt and dg.dtype == db.dtype == torch.float32
    tol = DX_TOL[dtype]
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(jdx.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(dg.numpy(), np.asarray(jdg), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), rtol=1e-4,
                               atol=1e-4)
    assert LN.ln_backward.launches == 0


@pytest.mark.parametrize("rows,d", [
    (65536, 512), (8, 65536), (8, 23296), (8, 23424), (16, 128), (12, 128),
    (16, 100), (24, 384), (65536, 2048), (40, 640), (8, 128)])
def test_ln_gate_matches_the_jax_gate(rows, d):
    assert LN.ln_bwd_ok(rows, d) == JLN.ln_bwd_ok(rows, d)
    assert LN._block_rows(rows, d) == JLN._block_rows(rows, d)


def _ln_program(dtype):
    """x [B, 8, 128] -> layer_norm (over the last axis) -> fc -> softmax
    cross-entropy -> mean, with its backward."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[8, 128], dtype=dtype,
                               stop_gradient=False)
        y = tfluid.layers.layer_norm(
            x, begin_norm_axis=2, param_attr=tfluid.ParamAttr(name="ln_s"),
            bias_attr=tfluid.ParamAttr(name="ln_b"))
        h = tfluid.layers.fc(y, size=128, num_flatten_dims=2)
        lab = tfluid.layers.data(name="lab", shape=[8, 1], dtype="int64")
        loss = tfluid.layers.mean(
            tfluid.layers.softmax_with_cross_entropy(h, lab))
        tfluid.backward.append_backward(loss)
    return main, startup, x, y


def _run_ln_program(dtype, seed=0):
    rng = np.random.RandomState(seed)
    main, startup, x, y = _ln_program(dtype)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    gamma = (1.0 + 0.1 * rng.randn(128)).astype(np.float32)
    beta = (0.1 * rng.randn(128)).astype(np.float32)
    tfluid.params_from_numpy({"ln_s": gamma, "ln_b": beta}, scope, "cpu")
    feed = {"x": rng.randn(4, 8, 128).astype(np.float32) * 2 + 0.5,
            "lab": rng.randint(0, 128, (4, 8, 1)).astype(np.int64)}
    fetch = [x.name, y.name, y.name + "@GRAD", x.name + "@GRAD",
             "ln_s@GRAD", "ln_b@GRAD"]
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    return gamma, beta, got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_kernel_route_through_grad_of_matches_jax_custom_vjp(monkeypatch,
                                                               dtype):
    """With FLAGS_ln_kernel and the gate forced on for CPU tensors, the
    layer_norm op's gradient comes from _LnAffine's backward, which calls
    the kernel wrapper once; y, dx, dgamma and dbeta match the JAX
    package's _ln_affine and its vjp (Pallas kernel in interpret mode) on
    the same x, gamma, beta and dy."""
    calls = []
    real = LN.ln_backward

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)
    monkeypatch.setattr(LN, "ln_backward", spy)
    monkeypatch.setattr(common, "on_card", lambda t: t.device.type == "cpu")
    monkeypatch.setenv("FLAGS_ln_kernel", "1")
    jreal = JLN.ln_backward
    monkeypatch.setattr(JLN, "ln_backward",
                        lambda *a, **k: jreal(*a, interpret=True, **k))
    gamma, beta, (x, y, dy, dx, dg, db) = _run_ln_program(dtype)
    assert calls == [(32, 128)]
    jdt = getattr(jnp, dtype)
    flat = jnp.asarray(x.reshape(32, 128), jdt)
    jy, vjp = jax.vjp(lambda a, s, b: jnn_ops._ln_affine(a, s, b, EPS),
                      flat, jnp.asarray(gamma), jnp.asarray(beta))
    jdx, jdg, jdb = vjp(jnp.asarray(dy.reshape(32, 128), jdt))
    tol = DX_TOL[dtype]
    np.testing.assert_allclose(y.reshape(32, 128),
                               np.asarray(jy.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(dx.reshape(32, 128),
                               np.asarray(jdx.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(dg, np.asarray(jdg), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(db, np.asarray(jdb), rtol=1e-4, atol=1e-4)


def test_ln_kernel_route_equals_the_plain_route(monkeypatch):
    """In f32 the flags-on step (plain LN backward through _LnAffine) and
    the flags-off step (autograd over the plain chain) agree."""
    calls = []
    real = LN.ln_backward
    monkeypatch.setattr(LN, "ln_backward",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.delenv("FLAGS_ln_kernel", raising=False)
    _, _, off = _run_ln_program("float32", seed=1)
    assert calls == []
    monkeypatch.setattr(common, "on_card", lambda t: t.device.type == "cpu")
    monkeypatch.setenv("FLAGS_ln_kernel", "1")
    _, _, on = _run_ln_program("float32", seed=1)
    assert calls == [1]
    for a, b in zip(off, on):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_ln_gate_needs_scale_and_bias(monkeypatch):
    from paddle_tpu_torch.fluid.ops import nn_ops
    monkeypatch.setattr(common, "on_card", lambda t: t.device.type == "cpu")
    monkeypatch.setenv("FLAGS_ln_kernel", "1")
    x, s = torch.zeros(4, 8, 128), torch.ones(128)
    assert nn_ops._ln_kernel_ok(x, s, s, 2)
    assert not nn_ops._ln_kernel_ok(x, None, s, 2)
    assert not nn_ops._ln_kernel_ok(x, s, None, 2)
    assert not nn_ops._ln_kernel_ok(torch.zeros(4, 8, 100), s, s, 2)
    monkeypatch.setenv("FLAGS_ln_kernel", "0")
    assert not nn_ops._ln_kernel_ok(x, s, s, 2)


def test_kernel_source_names_its_pallas_kernels():
    """csrc/layernorm.cu says which Pallas kernels it replaces, and its entry
    points are the ones the build binds."""
    import os
    from paddle_tpu_torch.ops import _build
    src = open(os.path.join(_build._CSRC, "layernorm.cu")).read()
    for sym in ("ln_backward", "Hopper",
                "paddle_tpu/ops/layernorm_kernel.py:43"):
        assert sym in src
    assert [fn for fn, _ in _build.SIGNATURES["layernorm"]] == \
        ["ln_backward"]
