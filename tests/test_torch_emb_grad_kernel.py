"""The port's embedding-gradient kernels (paddle_tpu_torch/ops/
emb_grad_kernel.py) against the JAX package's Pallas kernels in interpret
mode, their admission rule against the JAX one, the lookup_table_grad
lowering's FLAGS_emb_grad_kernel route, and the negative-id semantics of
lookup_table and its grad against the JAX lowerings.

On the CPU the wrappers run their plain versions; the CUDA kernels are held
against them on the card by chip_smoke.py. Inputs come from seeded numpy.
The douts are integer-valued and small, so every sum is exact in bf16 and
f32 in any order: all comparisons are exact (array_equal), as in
tests/test_emb_grad_kernel.py. The Zipf-skewed cases put about a tenth of
the ids on row 0; there a bf16 scatter's running sum can pass 256, and the
plain version then matches the Pallas kernel because both add in id order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid.ops.registry as jregistry
from paddle_tpu.ops import attention as jattention
from paddle_tpu.ops import emb_grad_kernel as JEG
from paddle_tpu_torch.fluid.ops import common, registry
from paddle_tpu_torch.ops import emb_grad_kernel as EG


def _case(vocab, dim, n, dtype, ids_mode, seed=0):
    """tests/test_emb_grad_kernel.py's cases: (ids int64, integer-valued
    dout f32)."""
    rng = np.random.RandomState(seed)
    if ids_mode == "clustered":        # many empty vocab rows
        ids = rng.randint(0, max(2, vocab // 64), n)
    elif ids_mode == "onerow":         # worst-case duplicates
        ids = np.full(n, vocab - 1)
    elif ids_mode == "zipf":           # row r with p proportional to 1/(r+1)
        p = 1.0 / np.arange(1, vocab + 1)
        ids = rng.choice(vocab, n, p=p / p.sum())
    else:
        ids = rng.randint(0, vocab, n)
    dout = rng.randint(-4, 5, (n, dim)).astype(np.float32)
    return ids.astype(np.int64), dout


CASES = [(64, 128, 256, "float32", "uniform"),
         (64, 128, 256, "float32", "clustered"),
         (64, 128, 256, "float32", "onerow"),
         (1024, 512, 2048, "bfloat16", "uniform"),
         (8192, 512, 1024, "bfloat16", "clustered"),
         (64, 128, 256, "float32", "zipf"),
         (8192, 512, 2048, "bfloat16", "zipf")]


@pytest.mark.parametrize("impl", ["scatter", "segsum"])
@pytest.mark.parametrize("vocab,dim,n,dtype,ids_mode", CASES)
def test_plain_emb_grad_matches_pallas_interpret(impl, vocab, dim, n, dtype,
                                                 ids_mode):
    ids, dout = _case(vocab, dim, n, dtype, ids_mode)
    jw = jnp.zeros((vocab, dim), getattr(jnp, dtype))
    want = JEG.emb_grad(jw, jnp.asarray(ids, jnp.int32), jnp.asarray(dout),
                        impl, interpret=True)
    tdt = getattr(torch, dtype)
    assert EG.emb_grad_ok((vocab, dim), n, impl, dtype=tdt)
    got = EG.emb_grad(torch.zeros(vocab, dim, dtype=tdt),
                      torch.from_numpy(ids), torch.from_numpy(dout), impl)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    assert EG.emb_grad_scatter.launches == EG.emb_grad_segsum.launches == 0


def test_plain_scatter_rounds_per_add_and_segsum_once():
    """The two variants' accumulation, against the Pallas kernels: scatter
    rounds to the bf16 table after every add (256 + 1 ties back to 256,
    twice), segsum sums a row in f32 and rounds once (258)."""
    ids = np.zeros(8, np.int64)
    dout = np.zeros((8, 128), np.float32)
    dout[:3, 0] = [256.0, 1.0, 1.0]
    w = torch.zeros(16, 128, dtype=torch.bfloat16)
    for impl, want in (("scatter", 256.0), ("segsum", 258.0)):
        got = EG.emb_grad(w, torch.from_numpy(ids), torch.from_numpy(dout),
                          impl)
        jgot = JEG.emb_grad(jnp.zeros((16, 128), jnp.bfloat16),
                            jnp.asarray(ids, jnp.int32), jnp.asarray(dout),
                            impl, interpret=True)
        assert got[0, 0].item() == float(jgot[0, 0]) == want, impl


def test_emb_grad_ok_matches_the_jax_gate():
    """test_emb_grad_ok_gates' cases, in both packages."""
    cases = [((64, 100), 256, "scatter", "bfloat16"),
             ((64, 128), 100, "scatter", "bfloat16"),
             ((64,), 256, "scatter", "bfloat16"),
             ((64, 128), 256, "bogus", "bfloat16"),
             ((30522, 768), 4096, "scatter", "bfloat16"),
             ((30522, 768), 4096, "segsum", "bfloat16"),
             ((8192, 512), 65536, "scatter", "bfloat16"),
             ((8192, 512), 65536, "segsum", "bfloat16"),
             ((8192, 512), 65536, "scatter", "float32"),
             ((8192, 512), 65536, "segsum", "float32"),
             ((1024, 512), 65536, "scatter", "float32"),
             ((64, 128), 0, "segsum", "float32")]
    for shape, n, impl, dtype in cases:
        want = JEG.emb_grad_ok(shape, n, impl, dtype=getattr(jnp, dtype))
        got = EG.emb_grad_ok(shape, n, impl, dtype=getattr(torch, dtype))
        assert got == want, (shape, n, impl, dtype)
    assert EG.emb_grad_ok((8192, 512), 65536, "scatter")
    assert not EG.emb_grad_ok((8192, 512), 65536, "scatter",
                              dtype=torch.float32)
    with pytest.raises(ValueError, match="bogus"):
        EG.emb_grad(torch.zeros(8, 128), torch.zeros(8, dtype=torch.int64),
                    torch.zeros(8, 128), "bogus")


def _lookup(w, ids, dout, jax_side):
    """(forward rows, table grad) of lookup_table and lookup_table_grad;
    the JAX lowerings or the port's."""
    attrs = {"padding_idx": -1, "is_sparse": False}
    if jax_side:
        w, ids, dout = (jnp.asarray(w), jnp.asarray(ids, jnp.int32),
                        jnp.asarray(dout))
        get, ctx = jregistry.get_lowering, None
    else:
        w, ids, dout = (torch.from_numpy(w), torch.from_numpy(ids),
                        torch.from_numpy(dout))
        get, ctx = registry.get_lowering, registry.LoweringContext("cpu")
    out = get("lookup_table")(ctx, {"W": [w], "Ids": [ids]}, attrs)["Out"][0]
    dw = get("lookup_table_grad")(
        ctx, {"W": [w], "Ids": [ids], "Out@GRAD": [dout]}, attrs)["W@GRAD"][0]
    return np.asarray(out, np.float32), np.asarray(dw, np.float32)


@pytest.mark.parametrize("vocab,dim,ids", [
    (4, 2, [-4, -5, 3, 4, -1]),
    # -vocab - 1, -vocab, -1, 0, vocab - 1, vocab
    (8, 3, [-9, -8, -1, 0, 7, 8]),
])
def test_negative_ids_wrap_as_in_the_jax_lowerings(vocab, dim, ids):
    """A negative id reads and accumulates row id + vocab (jnp.take and
    .at[].add wrap it once); an id still out of range reads NaN and
    contributes nothing."""
    w = np.arange(vocab * dim, dtype=np.float32).reshape(vocab, dim)
    ids = np.asarray(ids, np.int64).reshape(-1, 1)
    dout = np.repeat(np.arange(1, len(ids) + 1, dtype=np.float32)[:, None],
                     dim, axis=1)
    want_out, want_dw = _lookup(w, ids, dout, jax_side=True)
    got_out, got_dw = _lookup(w, ids, dout, jax_side=False)
    np.testing.assert_array_equal(got_out, want_out)
    np.testing.assert_array_equal(got_dw, want_dw)
    if vocab == 4:      # the worked example: rows 0 and 3 get 1 and 3 + 5
        np.testing.assert_array_equal(got_dw[:, 0], [1, 0, 0, 8])
        assert np.isnan(got_out[[1, 3]]).all()


@pytest.mark.parametrize("impl", ["scatter", "segsum"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lookup_table_grad_kernel_route_matches_jax(monkeypatch, impl, dtype):
    """FLAGS_emb_grad_kernel with the gate forced on for CPU tensors (the
    port) and the Pallas kernels in interpret mode (the JAX package): the
    same table grad, exactly, from ids with repeats; an id the lowering
    wraps and one still out of range take the XLA path's answer."""
    vocab, dim = 64, 128
    rng = np.random.RandomState(6)
    ids = rng.randint(0, vocab, (16, 8)).astype(np.int64)
    ids[0, :2] = [-3, vocab]          # wraps to vocab - 3; out of range
    dout = rng.randint(-4, 5, (16, 8, dim)).astype(np.float32)
    w = np.zeros((vocab, dim), np.float32)
    tdt = getattr(torch, dtype)
    attrs = {"padding_idx": -1, "is_sparse": False}
    lower = registry.get_lowering("lookup_table_grad")
    args = {"W": [torch.from_numpy(w).to(tdt)],
            "Ids": [torch.from_numpy(ids)],
            "Out@GRAD": [torch.from_numpy(dout).to(tdt)]}
    ctx = registry.LoweringContext("cpu")
    plain = lower(ctx, args, attrs)["W@GRAD"][0]
    calls = []
    real = EG.emb_grad
    monkeypatch.setattr(EG, "emb_grad",
                        lambda *a: calls.append(a[3]) or real(*a))
    monkeypatch.setattr(common, "on_card", lambda t: t.device.type == "cpu")
    monkeypatch.setenv("FLAGS_emb_grad_kernel", impl)
    got = lower(ctx, args, attrs)["W@GRAD"][0]
    assert calls == [impl] and got.dtype == tdt
    jreal = JEG.emb_grad
    monkeypatch.setattr(jattention, "_use_pallas", lambda: True)
    monkeypatch.setattr(JEG, "emb_grad",
                        lambda *a, **k: jreal(*a, interpret=True))
    # the Pallas kernels take ids unchecked: hand them the ids as the XLA
    # path reads them (-3 wrapped), and the out-of-range id as an in-range
    # one with a zero dout row, which adds nothing
    jd = dout.copy()
    jd[0, 1] = 0.0
    jids = ids.copy()
    jids[0, :2] = [vocab - 3, 0]
    want = jregistry.get_lowering("lookup_table_grad")(
        None, {"W": [jnp.asarray(w, getattr(jnp, dtype))],
               "Ids": [jnp.asarray(jids)],
               "Out@GRAD": [jnp.asarray(jd, getattr(jnp, dtype))]},
        attrs)["W@GRAD"][0]
    np.testing.assert_array_equal(got.float().numpy(), plain.float().numpy())
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emb_grad_sorted_branch_matches_jax(monkeypatch, dtype):
    """FLAGS_emb_grad_sorted: the presorted scatter-add against the JAX
    lowering's indices_are_sorted scatter, with the same flag set, and
    against the unsorted plain route: the same table grad, exactly, from ids
    with repeats and one id out of range. The id the port wraps (-3) goes to
    the JAX side wrapped, so its argsort sees the order the port's does."""
    vocab, dim = 64, 128
    rng = np.random.RandomState(7)
    ids = rng.randint(0, vocab, (16, 8)).astype(np.int64)
    ids[0, :2] = [-3, vocab]
    dout = rng.randint(-4, 5, (16, 8, dim)).astype(np.float32)
    w = np.zeros((vocab, dim), np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    attrs = {"padding_idx": -1, "is_sparse": False}
    lower = registry.get_lowering("lookup_table_grad")
    args = {"W": [torch.from_numpy(w).to(tdt)],
            "Ids": [torch.from_numpy(ids)],
            "Out@GRAD": [torch.from_numpy(dout).to(tdt)]}
    ctx = registry.LoweringContext("cpu")
    plain = lower(ctx, args, attrs)["W@GRAD"][0]
    sorts = []
    real = torch.argsort
    monkeypatch.setattr(torch, "argsort",
                        lambda *a, **k: sorts.append(1) or real(*a, **k))
    monkeypatch.setenv("FLAGS_emb_grad_sorted", "1")
    got = lower(ctx, args, attrs)["W@GRAD"][0]
    assert sorts == [1] and got.dtype == tdt
    jids = ids.copy()
    jids[0, 0] = vocab - 3
    want = jregistry.get_lowering("lookup_table_grad")(
        None, {"W": [jnp.asarray(w, jdt)], "Ids": [jnp.asarray(jids)],
               "Out@GRAD": [jnp.asarray(dout, jdt)]}, attrs)["W@GRAD"][0]
    np.testing.assert_array_equal(got.float().numpy(), plain.float().numpy())
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_kernel_source_names_its_pallas_kernels():
    """csrc/emb_grad.cu says which Pallas kernels it replaces, and its entry
    points are the ones the build binds."""
    import os
    from paddle_tpu_torch.ops import _build
    src = open(os.path.join(_build._CSRC, "emb_grad.cu")).read()
    for sym in ("emb_grad_scatter", "emb_grad_segsum", "Hopper",
                "paddle_tpu/ops/emb_grad_kernel.py:96",
                "paddle_tpu/ops/emb_grad_kernel.py:147"):
        assert sym in src
    assert [fn for fn, _ in _build.SIGNATURES["emb_grad"]] == [
        "emb_grad_scatter", "emb_grad_segsum"]


def test_kernels_need_no_sort_atomics_or_memset():
    """One launch a call: csrc/emb_grad.cu holds no atomic and no memset,
    and the CUDA route of both wrappers sorts nothing (the plain versions'
    stable sort defines the order the kernels keep)."""
    import inspect
    import os
    from paddle_tpu_torch.ops import _build
    src = open(os.path.join(_build._CSRC, "emb_grad.cu")).read()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    for word in ("atomicAdd", "atomicCAS", "cudaMemsetAsync", "cudaMemset"):
        assert word not in code, word
    for fn in (EG.emb_grad_scatter, EG.emb_grad_segsum, EG._launch):
        body = inspect.getsource(fn)
        for word in ("argsort", "searchsorted", "_segments", "arange"):
            assert word not in body, (fn.__name__, word)


def test_probe_tool_instruments_the_kernel_source():
    """tools/torch_emb_grad_probe.py patches csrc/emb_grad.cu at fixed
    anchors (its per-phase cycle counters, PERF.md): each must still be in
    the source exactly once. It runs on the card, which has no JAX."""
    import ast
    import importlib.util
    import os
    from paddle_tpu_torch.ops import _build
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, "tools", "torch_emb_grad_probe.py")
    mods = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    assert "paddle_tpu_torch.ops" in mods
    assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib",
                                                       "paddle_tpu")]
    spec = importlib.util.spec_from_file_location("torch_emb_grad_probe",
                                                  path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = open(os.path.join(_build._CSRC, "emb_grad.cu")).read()
    out = tool.instrument(src)
    assert "g_dbg" in out and "set_dbg" in out
    assert out.count("clock64()") >= 8
