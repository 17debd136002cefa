"""The port's plain attention forward versions in bfloat16 against the JAX
package's Pallas kernels run in interpret mode on the CPU.

On the card chip_smoke.py holds the bf16 tensor-core kernels to these plain
versions, so here their rounding points are pinned in bf16: the same seeded
numpy inputs, cast to bf16 in both packages, at head widths 16, 40 (a
multiple of 8 but not of 16), 256 (the widest the tensor-core kernels
take: bench.py's wide Transformer) and 264 (past it: the CUDA-core kernels
in bf16) and ragged lengths. The one-pass plain version
must equal the Pallas kernel bit for bit (both normalise P in f32 and round
it once to bf16). The flash plain version runs in one tile and the Pallas
kernel rounds P to bf16 per k-tile against the running max. Each rounding
moves p_j by at most 2^-9 of it, so the two sums sum_j p_j v_j / l differ by
at most 2^-8 max_j |v_j| (per output column), and the outputs, each rounded
once to bf16, by that plus one bf16 unit in the last place of the element.
The lse (f32) may differ by 1e-5.
"""
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.ops import attention as JA
from paddle_tpu_torch.ops import attention as TA

LSE_TOL = 1e-5
SHAPES = [(48, 48), (24, 40), (40, 24)]     # (T_q, T_k)


def _qkv(seed, t_q, t_k, d, b=2, h=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype("float32") for t in (t_q, t_k, t_k)]


def _both(arrays):
    """The same values as bf16 jax and torch arrays."""
    jx = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]
    tx = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    return jx, tx


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _ulp_bf16(x):
    """One bf16 unit in the last place of each element of x (f32 array)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def _within_p_rounding(got, want, v):
    """|got - want| <= one bf16 ulp of the larger of the two plus 2^-8 of
    the largest |v| over the keys in that (batch, head, column)."""
    got, want = _f32(got), _f32(want)
    vmax = np.abs(_f32(v)).max(axis=1, keepdims=True)
    bound = _ulp_bf16(np.maximum(np.abs(got), np.abs(want))) + \
        2.0 ** -8 * vmax
    ratio = np.abs(got - want) / bound
    assert ratio.max() <= 1.0, "max |diff| / bound = %g" % ratio.max()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t_q,t_k", SHAPES)
@pytest.mark.parametrize("d", [16, 40, 256, 264])
def test_onepass_plain_bf16_equals_pallas_interpret(d, t_q, t_k, causal):
    """Bit for bit at D 16 and 40, where XLA and PyTorch sum each score's D
    products in the same order on the CPU. At D 256 the two orders differ,
    so a P near a bf16 rounding midpoint may round the other way: the
    flash test's bound (one rounding of P, one of the output) holds it."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(11, t_q, t_k, d))
    want = JA.onepass_attention_fwd_bthd(jq, jk, jv, causal=causal, block_q=8,
                                         interpret=True)
    got = TA.onepass_attention_fwd_bthd(tq, tk, tv, causal)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    if d <= 40:
        np.testing.assert_array_equal(_f32(got), _f32(want))
    else:
        _within_p_rounding(got, want, tv)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t_q,t_k", SHAPES)
@pytest.mark.parametrize("d", [16, 40, 256, 264])
def test_flash_plain_bf16_matches_pallas_interpret(d, t_q, t_k, causal):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(12, t_q, t_k, d))
    want_out, want_lse = JA.flash_attention_fwd_bthd(
        jq, jk, jv, causal=causal, block_q=8, block_k=8, interpret=True)
    out, lse = TA.flash_attention_fwd_bthd(tq, tk, tv, causal)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    # causal T_q > T_k: rows with no key differ on purpose (the next test)
    rows = slice(max(0, t_q - t_k) if causal else 0, None)
    _within_p_rounding(out[:, rows], np.asarray(want_out)[:, rows], tv)
    np.testing.assert_allclose(lse[:, rows].numpy(),
                               np.asarray(want_lse)[:, rows], rtol=LSE_TOL,
                               atol=LSE_TOL)


@pytest.mark.parametrize("d", [16, 40, 256, 264])
def test_bf16_keyless_rows_follow_the_dense_path(d):
    """Causal with T_q > T_k: the rows before T_q - T_k have no key. Both
    plain versions give them the dense path's uniform softmax over all keys
    in bf16 as in f32 (the Pallas flash kernel's answer depends on its
    tiles, see test_torch_attention.py)."""
    t_q, t_k = 40, 24
    keyless = t_q - t_k
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(13, t_q, t_k, d))
    dense = np.asarray(JA.dense_attention_bthd(jq, jk, jv, causal=True),
                       np.float32)
    out, lse = TA.flash_attention_fwd_bthd(tq, tk, tv, causal=True)
    _within_p_rounding(out[:, :keyless], dense[:, :keyless], tv)
    np.testing.assert_allclose(lse[:, :keyless].numpy(),
                               np.full(lse[:, :keyless].shape,
                                       TA.NEG_INF + np.log(t_k), np.float32),
                               rtol=LSE_TOL)
    onepass = TA.onepass_attention_fwd_bthd(tq, tk, tv, causal=True)
    np.testing.assert_array_equal(_f32(onepass)[:, :keyless],
                                  dense[:, :keyless])


def _global_kernels():
    """(source, name, template arguments as the trace prints them) of every
    __global__ function in the port's CUDA sources."""
    import os
    from paddle_tpu_torch.ops import _build
    found = []
    for src in sorted(os.listdir(_build._CSRC)):
        if not src.endswith(".cu"):
            continue
        text = open(os.path.join(_build._CSRC, src)).read()
        for tmpl, name in re.findall(
                r"(?:template\s*<([^>]*)>\s*)?__global__\s+void\s+"
                r"(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", text):
            args = ", ".join("__nv_bfloat16" if p.strip().startswith(
                "typename") else "64" for p in tmpl.split(",")) if tmpl \
                else None
            found.append((src, name, args))
    return found


def _profile_tool():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "torch_profile_serve.py")
    spec = importlib.util.spec_from_file_location("torch_profile_serve", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("src,name,args", _global_kernels())
def test_profile_tool_classifies_every_port_kernel(src, name, args):
    """The trace shows each kernel by its demangled name; the profiling
    tool must count it as a port kernel, not as a product or "other"."""
    kind = _profile_tool()._kind(
        "void (anonymous namespace)::%s%s(int, float)"
        % (name, "" if args is None else "<%s>" % args))
    assert kind not in ("matmul", "other"), (src, name, kind)


@pytest.mark.parametrize("name,kind", [
    ("flash_bwd_dq_kernel_wgmma<64>", "flash_bwd_dq"),
    ("flash_bwd_dkv_kernel_wgmma<128>", "flash_bwd_dkv"),
    ("flash_bwd_dq_kernel<float>", "flash_bwd_dq"),
    ("bwd_dkv_kernel<float, (bool)0>", "attention_bwd_dkv")])
def test_profile_tool_names_the_flash_backward_kernels(name, kind):
    """The tensor-core dkv kernel's name holds "bwd_dkv_kernel", the
    CUDA-core kernel's that the one-pass and the float32 flash backward
    share: it must count as the flash dkv kernel."""
    assert _profile_tool()._kind(
        "void (anonymous namespace)::%s(int, float)" % name) == kind


@pytest.mark.parametrize("name", ["onepass_bwd_dq_kernel_wgmma<256>",
                                  "onepass_bwd_dkv_kernel_wgmma<64>",
                                  "onepass_bwd_dq_kernel<float>"])
def test_profile_tool_names_the_onepass_backward_kernels(name):
    """The tensor-core one-pass dkv kernel's name holds "bwd_dkv_kernel" as
    well: it must count as the one-pass backward, not the flash dkv."""
    assert _profile_tool()._kind(
        "void (anonymous namespace)::%s(int, float)" % name) == "onepass_bwd"


@pytest.mark.parametrize("name,kind", [
    ("adam_multi_kernel", "adam"),
    ("ln_bwd_kernel<__nv_bfloat16, 8, 2>", "ln_bwd"),
    ("ln_bwd_kernel_wide<float>", "ln_bwd"),
    ("onepass_fwd_kernel<__nv_bfloat16>", "onepass_fwd"),
    ("flash_fwd_kernel<__nv_bfloat16>", "flash_fwd"),
    ("onepass_bwd_dq_kernel<__nv_bfloat16>", "onepass_bwd"),
    ("flash_bwd_dq_kernel<__nv_bfloat16>", "flash_bwd_dq"),
    ("bwd_dkv_kernel<__nv_bfloat16, (bool)1>", "attention_bwd_dkv")])
def test_profile_tool_names_the_multi_adam_ln_and_wide_kernels(name, kind):
    """The multi-tensor Adam kernel, both LayerNorm backward kernels and the
    CUDA-core attention kernels instantiated for bf16 (past D = 256), as
    the trace names them."""
    assert _profile_tool()._kind(
        "void (anonymous namespace)::%s(int, float)" % name) == kind


def test_every_kernel_source_has_a_global_function():
    names = {name for _, name, _ in _global_kernels()}
    assert {"onepass_fwd_kernel_wgmma", "flash_fwd_kernel_wgmma",
            "onepass_fwd_kernel", "flash_fwd_kernel",
            "flash_bwd_dq_kernel_wgmma", "flash_bwd_dkv_kernel_wgmma",
            "onepass_bwd_dq_kernel_wgmma",
            "onepass_bwd_dkv_kernel_wgmma", "adam_multi_kernel",
            "ln_bwd_kernel", "ln_bwd_kernel_wide"} <= names
    assert len({src for src, _, _ in _global_kernels()}) == 6


def test_attention_probe_tool_imports_no_jax():
    """tools/torch_attention_probe.py runs on the card, which has no JAX."""
    import ast
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "torch_attention_probe.py")
    mods = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    assert "paddle_tpu_torch.ops" in mods and "chip_smoke" in mods
    assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib",
                                                       "paddle_tpu")]
