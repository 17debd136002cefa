"""The host ops of ``paddle_tpu_torch/fluid/host_ops.py`` against the JAX
package's on the CPU (tools/torch_input_programs.py builds the programs).

- ``layers.Go`` with ``Executor.go_join``: a block's copy of a parameter
  is the value before the parent's next Adam step, which updates it in
  place (the copy is taken before the thread starts); the second block's
  product as the JAX package's from the same state within 1e-5; an error
  in a block surfaces at go_join; a block still waiting raises
  TimeoutError and stays joinable; the child scope reads through to its
  parent and keeps its own writes.
- ``split_ids`` / ``merge_ids``: each shard exactly the JAX handler's and
  numpy's ids % N in the ids' order (negative ids too), the merged rows
  exactly the lookup of the ids, and ``merge_rows`` exactly the
  reference's loop (shards holding spare rows read from their first row,
  too few rows an IndexError); with two Ids inputs both outputs exactly
  the JAX handler's.
- ``py_func``: forward; backward with ``skip_vars_in_backward_input``
  (the activation tanh in numpy, its input skipped), its gradients within
  1e-5 of layers.tanh's and of the JAX package's; a bfloat16 input is
  handed over as float32 and a bfloat16 output comes back bfloat16.
- ``save_combine`` / ``load_combine``: each package loads the other's
  file (float32, int64 and bfloat16 variables), exactly.
- ``delete_var`` drops the value, ``fake_init`` zero-fills only an absent
  table, and the two engine stubs raise without naming a TPU.
"""
import importlib.util
import os
import threading

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import host_ops
from paddle_tpu_torch.fluid.executor import as_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
spec = importlib.util.spec_from_file_location(
    "torch_input_programs", os.path.join(ROOT, "tools",
                                         "torch_input_programs.py"))
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)

TOL = 1e-5


def _cpu(fluid):
    return fluid.Executor(fluid.CPUPlace())


def _np(v):
    return as_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v)


# ---- Go ---------------------------------------------------------------------

def _go(fluid, state=None):
    """One run of go_program with its first block released after the
    parent's step: (weight before, weight after, the child scopes). On the
    port the step's update is also applied in place to the tensor the go
    op read, as the card's Adam kernel updates it (the CPU's plain Adam
    writes a new tensor)."""
    ev = threading.Event()
    m = tool.go_program(fluid, ev.wait, **tool.GO_NARROW)
    exe, scope = _cpu(fluid), fluid.Scope()
    exe.run(m.startup, scope=scope)
    if state is not None:
        scope.set("go_w", state if fluid is jfluid else
                  torch.from_numpy(state.copy()))
    read = scope.get("go_w")
    before = _np(read).copy()
    exe.run(m.main, feed=tool.go_batch(0, **tool.GO_NARROW),
            fetch_list=[m.loss], scope=scope)
    after = _np(scope.get("go_w")).copy()
    if fluid is tfluid:
        read.copy_(scope.get("go_w"))
    ev.set()
    kids = exe.go_join(60)
    return m, before, after, kids


def test_go_block_reads_its_inputs_before_the_parents_next_step():
    m, before, after, kids = _go(tfluid)
    assert len(kids) == 2
    assert not np.array_equal(before, after)
    np.testing.assert_array_equal(_np(kids[0].get(m.extra["snapshot"])),
                                  before)
    ops = [op.type for op in m.main.global_block().ops]
    assert ops[:2] == ["go", "go"] and "adam" in ops


def test_go_blocks_match_the_jax_package():
    m, before, _, kids = _go(tfluid)
    jm, jbefore, _, jkids = _go(jfluid, state=before)
    np.testing.assert_array_equal(jbefore, before)
    x = tool.go_batch(0, **tool.GO_NARROW)["x"]
    got = _np(kids[1].get(m.extra["product"]))
    want = np.asarray(jkids[1].get(jm.extra["product"]))
    np.testing.assert_allclose(got, x @ before, rtol=TOL, atol=TOL)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    np.testing.assert_array_equal(
        np.asarray(jkids[0].get(jm.extra["snapshot"])), before)


def test_go_without_the_clone_reads_the_updated_weight():
    """The control the card's lockstep runs: no copy, and the block reads
    the parent's in-place update."""
    orig = host_ops._snapshot
    host_ops._snapshot = lambda v: v
    try:
        m, before, after, kids = _go(tfluid)
    finally:
        host_ops._snapshot = orig
    np.testing.assert_array_equal(_np(kids[0].get(m.extra["snapshot"])),
                                  after)


def _raising_go(fluid, fn):
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        out = main.global_block().create_var(name="o", shape=[1],
                                             dtype="float32")
        with fluid.layers.Go().block():
            fluid.layers.py_func(fn, [], out)
    return main


def test_go_error_surfaces_at_go_join():
    def fail():
        raise ValueError("block failed")
    for fluid in (tfluid, jfluid):
        exe = _cpu(fluid)
        exe.run(_raising_go(fluid, fail), scope=fluid.Scope())
        with pytest.raises(ValueError, match="block failed"):
            exe.go_join(30)
        assert exe.go_join(1) == []


def test_go_join_times_out_and_stays_joinable():
    ev = threading.Event()
    exe = _cpu(tfluid)
    exe.run(_raising_go(tfluid, lambda: (ev.wait(30),
                                         np.ones(1, np.float32))[1]),
            scope=tfluid.Scope())
    with pytest.raises(TimeoutError):
        exe.go_join(0.05)
    ev.set()
    kid, = exe.go_join(30)
    np.testing.assert_array_equal(_np(kid.get("o")), [1.0])


def test_child_scope_reads_its_parent_and_keeps_its_writes():
    parent = tfluid.Scope()
    parent.set("a", torch.ones(2))
    child = tfluid.Scope(parent=parent)
    assert child.has("a") and child.find_var("a") is not None
    child.set("a", torch.zeros(2))
    np.testing.assert_array_equal(_np(parent.get("a")), [1, 1])
    np.testing.assert_array_equal(_np(child.get("a")), [0, 0])
    assert child.get("b") is None and not child.has("b")


# ---- split_ids / merge_ids --------------------------------------------------

def _split_merge(fluid, ids, table=None):
    """(the table, [merged, direct, shard ids...]); `table` replaces the
    startup's."""
    m = tool.split_merge_program(fluid, **tool.SPLIT_NARROW)
    exe, scope = _cpu(fluid), fluid.Scope()
    exe.run(m.startup, scope=scope)
    if table is not None:
        scope.set("split_table", table)
    table = _np(scope.get("split_table")).copy()
    fetch = [m.out.name, m.extra["direct"]] + m.extra["shards"]
    return table, [_np(v) for v in exe.run(m.main, feed={"ids": ids},
                                           fetch_list=fetch, scope=scope)]


@pytest.mark.parametrize("negative", [False, True], ids=["ids", "negative"])
def test_split_and_merge_ids_are_exact_and_the_jax_packages(negative):
    ids = tool.split_ids_batch(0, **tool.SPLIT_NARROW)["ids"]
    if negative:
        ids = ids - 15
    table, (merged, direct, *shards) = _split_merge(tfluid, ids)
    flat = ids.reshape(-1)
    n = tool.SPLIT_NARROW["shards"]
    for i, s in enumerate(shards):
        np.testing.assert_array_equal(s.reshape(-1), flat[flat % n == i])
        assert s.dtype == np.int64 and s.shape[1:] == (1,)
    np.testing.assert_array_equal(merged, direct.reshape(merged.shape))
    rows = [table[np.asarray(s).reshape(-1) % table.shape[0]]
            for s in shards]
    if not negative:
        np.testing.assert_array_equal(
            merged, tool.merge_in_id_order(ids, rows))
        _, (jmerged, _, *jshards) = _split_merge(jfluid, ids, table)
        for s, j in zip(shards, jshards):
            np.testing.assert_array_equal(s, j)
        np.testing.assert_array_equal(merged, jmerged)


def test_merge_rows_is_the_reference_loop():
    r = np.random.RandomState(3)
    ids = r.randint(-50, 50, 40)
    rows = [r.randn(int((ids % 3 == k).sum()), 2).astype(np.float32)
            for k in range(3)]
    got = host_ops.merge_rows(torch.from_numpy(ids),
                              [torch.from_numpy(x) for x in rows])
    np.testing.assert_array_equal(got.numpy(),
                                  tool.merge_in_id_order(ids, rows))


def test_merge_rows_reads_each_shard_from_its_first_row():
    """Shards holding more rows than the ids take are read from their
    first rows; a shard holding too few raises IndexError, as the
    reference loop does."""
    r = np.random.RandomState(4)
    ids = r.randint(0, 60, 30)
    rows = [r.randn(int((ids % 3 == k).sum()) + 2 + k, 2).astype(np.float32)
            for k in range(3)]
    got = host_ops.merge_rows(torch.from_numpy(ids),
                              [torch.from_numpy(x) for x in rows])
    np.testing.assert_array_equal(got.numpy(),
                                  tool.merge_in_id_order(ids, rows))
    short = [x[:int((ids % 3 == k).sum())] for k, x in enumerate(rows)]
    short[1] = short[1][:-1]
    with pytest.raises(IndexError):
        tool.merge_in_id_order(ids, short)
    with pytest.raises(IndexError):
        host_ops.merge_rows(torch.from_numpy(ids),
                            [torch.from_numpy(x) for x in short])


def _two_ids_merge(fluid, a, b, table):
    """split_ids over two Ids inputs into 3 shards, each shard's rows of
    `table`, merge_ids back into two outputs: their values."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        helper = fluid.layer_helper.LayerHelper("split_merge")
        blk = main.global_block()
        ids = [L.data(name=n, shape=[len(v), 1], dtype="int64",
                      append_batch_size=False)
               for n, v in (("a", a), ("b", b))]
        shards = [helper.create_variable_for_type_inference("int64")
                  for _ in range(3)]
        blk.append_op(type="split_ids", inputs={"Ids": ids},
                      outputs={"Out": shards})
        rows = [L.embedding(input=s, size=list(table.shape),
                            param_attr=fluid.ParamAttr(name="two_table"))
                for s in shards]
        outs = [helper.create_variable_for_type_inference("float32")
                for _ in range(2)]
        blk.append_op(type="merge_ids", inputs={"Ids": ids, "X": rows},
                      outputs={"Out": outs})
    exe, scope = _cpu(fluid), fluid.Scope()
    exe.run(startup, scope=scope)
    scope.set("two_table", table if fluid is jfluid else
              torch.from_numpy(table.copy()))
    got = exe.run(main, feed={"a": a, "b": b}, fetch_list=outs + shards,
                  scope=scope)
    return [_np(v) for v in got]


def test_merge_ids_with_two_ids_inputs_is_the_jax_handlers():
    """Two Ids inputs: split_ids shards their concatenation, and each of
    merge_ids' outputs reads the shards from their first rows, exactly
    as the JAX handler's loop; the first output is the lookup of the
    first ids."""
    r = np.random.RandomState(5)
    a = r.randint(0, 20, (11, 1)).astype(np.int64)
    b = r.randint(0, 20, (7, 1)).astype(np.int64)
    table = r.randn(20, 4).astype(np.float32)
    got = _two_ids_merge(tfluid, a, b, table)
    want = _two_ids_merge(jfluid, a, b, table)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], table[a.reshape(-1)])
    shard_rows = [table[s.reshape(-1)] for s in got[2:]]
    np.testing.assert_array_equal(got[1],
                                  tool.merge_in_id_order(b, shard_rows))


# ---- py_func ----------------------------------------------------------------

def _py_func_grads(fluid, use, state=None):
    m = tool.py_func_programs(fluid, use, **tool.PYFUNC_NARROW)
    exe, scope = _cpu(fluid), fluid.Scope()
    exe.run(m.startup, scope=scope)
    if state is not None:
        for n, v in state.items():
            scope.set(n, v if fluid is jfluid else torch.from_numpy(v))
    names = ["pf_w1", "pf_b1", "pf_w2", "pf_b2"]
    start = {n: _np(scope.get(n)).copy() for n in names}
    out = exe.run(m.main, feed=tool.py_func_batch(0, **tool.PYFUNC_NARROW),
                  fetch_list=[m.loss] + [n + "@GRAD" for n in names],
                  scope=scope)
    return m, start, [_np(v) for v in out]


def test_py_func_backward_skips_its_input_and_matches_tanh_and_jax():
    m, start, got = _py_func_grads(tfluid, True)
    ops = [op.type for op in m.main.global_block().ops]
    assert "py_func" in ops and "py_func_grad" in ops
    _, _, want = _py_func_grads(tfluid, False, start)
    _, _, jax = _py_func_grads(jfluid, True, start)
    for g, w, j in zip(got, want, jax):
        assert np.abs(g - w).max() <= TOL * max(np.abs(w).max(), 1e-12)
        assert np.abs(g - j).max() <= TOL * max(np.abs(j).max(), 1e-12)


def test_py_func_forward_with_several_inputs_and_outputs():
    for fluid in (tfluid, jfluid):
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            a = fluid.layers.data(name="a", shape=[3], dtype="float32")
            b = fluid.layers.data(name="b", shape=[3], dtype="float32")
            blk = main.global_block()
            s = blk.create_var(name="s", shape=[-1, 3], dtype="float32")
            d = blk.create_var(name="d", shape=[-1, 3], dtype="float32")
            fluid.layers.py_func(lambda u, v: (u + v, u - v), [a, b], [s, d])
            total = fluid.layers.reduce_sum(s) + fluid.layers.reduce_sum(d)
        r = np.random.RandomState(1)
        av, bv = r.rand(2, 3).astype("float32"), r.rand(2, 3).astype(
            "float32")
        got, = _cpu(fluid).run(main, feed={"a": av, "b": bv},
                               fetch_list=[total], scope=fluid.Scope())
        np.testing.assert_allclose(float(np.asarray(got).reshape(())),
                                   float(2 * av.sum()), rtol=1e-5)


def test_py_func_hands_bfloat16_over_as_float32():
    seen = []
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        x = tfluid.layers.data(name="x", shape=[3], dtype="float32")
        xb = tfluid.layers.cast(x, "bfloat16")
        out = main.global_block().create_var(name="pb", shape=[-1, 3],
                                             dtype="bfloat16")
        tfluid.layers.py_func(lambda v: (seen.append(v.dtype), v * 2)[1],
                              xb, out)
    xv = np.array([[1.5, -2.0, 3.25]], np.float32)
    exe = _cpu(tfluid)
    got, = exe.run(main, feed={"x": xv}, fetch_list=[out],
                   scope=tfluid.Scope(), return_numpy=False)
    assert seen == [np.float32]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), xv * 2)


# ---- save_combine / load_combine --------------------------------------------

VALUES = {"ca": np.random.RandomState(4).randn(3, 2).astype(np.float32),
          "cb": np.arange(5, dtype=np.int64),
          "cc": np.array([1.5, -0.25, 3.0], np.float32)}
DTYPES = {"ca": "float32", "cb": "int64", "cc": "bfloat16"}


def _save(fluid, path):
    names = sorted(VALUES)
    save, _ = tool.combine_programs(
        fluid, names, [VALUES[n].shape for n in names],
        [DTYPES[n] for n in names], path)
    scope = fluid.Scope()
    for n in names:
        v = VALUES[n]
        if fluid is tfluid:
            t = torch.from_numpy(v)
            scope.set(n, t.to(torch.bfloat16) if DTYPES[n] == "bfloat16"
                      else t)
        else:
            import jax.numpy as jnp
            scope.set(n, jnp.asarray(v, jnp.bfloat16)
                      if DTYPES[n] == "bfloat16" else v)
    _cpu(fluid).run(save, scope=scope)


def _load_back(fluid, path):
    names = sorted(VALUES)
    _, load = tool.combine_programs(
        fluid, names, [VALUES[n].shape for n in names],
        [DTYPES[n] for n in names], path)
    scope = fluid.Scope()
    _cpu(fluid).run(load, scope=scope)
    return scope


@pytest.mark.parametrize("writer,reader", [(tfluid, jfluid),
                                           (jfluid, tfluid),
                                           (tfluid, tfluid)],
                         ids=["port_to_jax", "jax_to_port", "port_to_port"])
def test_combined_file_loads_in_either_package(tmp_path, writer, reader):
    path = str(tmp_path / "combined")
    _save(writer, path)
    with np.load(path) as z:
        assert sorted(z.files) == ["v0", "v1", "v2.bf16"]
    scope = _load_back(reader, path)
    for n, v in VALUES.items():
        got = scope.get(n)
        if reader is tfluid:
            want_dtype = {"float32": torch.float32, "int64": torch.int64,
                          "bfloat16": torch.bfloat16}[DTYPES[n]]
            assert got.dtype == want_dtype, n
        np.testing.assert_array_equal(_np(got).astype(v.dtype), v)


# ---- delete_var, fake_init, the stubs ---------------------------------------

def test_delete_var_and_fake_init():
    for fluid in (tfluid, jfluid):
        m = tool.misc_program(fluid, **tool.SPLIT_NARROW)
        scope = fluid.Scope()
        exe = _cpu(fluid)
        x = np.ones((2, 4), np.float32)
        out, = exe.run(m.main, feed={"x": x}, fetch_list=[m.out],
                       scope=scope)
        np.testing.assert_array_equal(np.asarray(out), 3 * x)
        table = _np(scope.get(m.extra["table"]))
        assert table.shape == (30, 3) and not table.any()
        assert scope.get(m.extra["deleted"]) is None
        with pytest.raises(ValueError, match="not produced"):
            exe.run(m.main, feed={"x": x}, fetch_list=[m.extra["deleted"]],
                    scope=scope)
        # an existing table is kept
        kept = np.full((30, 3), 2.0, np.float32)
        scope.set(m.extra["table"], kept if fluid is jfluid else
                  torch.from_numpy(kept))
        exe.run(m.main, feed={"x": x}, scope=scope)
        np.testing.assert_array_equal(_np(scope.get(m.extra["table"])), kept)


@pytest.mark.parametrize("kind", ["tensorrt_engine", "ngraph_engine"])
def test_engine_stubs_raise_without_naming_a_tpu(kind):
    with pytest.raises(NotImplementedError) as e:
        _cpu(tfluid).run(tool.engine_program(tfluid, kind),
                         scope=tfluid.Scope())
    assert kind in str(e.value) and "TPU" not in str(e.value)
    with pytest.raises(NotImplementedError):
        _cpu(jfluid).run(tool.engine_program(jfluid, kind),
                         scope=jfluid.Scope())


def test_the_port_has_26_of_the_40_host_handlers():
    """The port has 28 of the JAX package's 40 host handlers: the 12 left
    are item 7's and item 9's distributed ones. (The name is from before
    the two record-file handlers were ported.)"""
    from paddle_tpu.fluid import executor as jexe
    from paddle_tpu_torch.fluid import executor as texe
    import paddle_tpu.fluid.host_ops  # noqa: F401
    import paddle_tpu.fluid.ps_ops  # noqa: F401
    missing = set(jexe._HOST_HANDLERS) - set(texe._HOST_HANDLERS)
    assert len(jexe._HOST_HANDLERS) == 40
    assert set(texe._HOST_HANDLERS) <= set(jexe._HOST_HANDLERS)
    assert len(texe._HOST_HANDLERS) == 28
    assert {"create_recordio_file_reader", "open_files"} <= \
        set(texe._HOST_HANDLERS)
    assert missing == {"checkpoint_notify", "gen_nccl_id", "nccl_init",
                       "fetch_barrier", "listen_and_serv", "prefetch",
                       "ps_init", "ps_init_barrier", "recv", "send",
                       "send_barrier", "send_sparse"}
