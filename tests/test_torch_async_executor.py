"""``fluid.AsyncExecutor`` and ``fluid.DataFeedDesc`` of the port against
the JAX package's on the CPU, over record files of DeepFM samples
(tools/torch_recordio_programs.py: ``ctr_programs`` at CTR_NARROW's
widths, Adam, sparse tables).

- ``thread_num=1`` over one file: each step's loss within 1e-6 of the JAX
  package's, from its parameters carried over by ``params_from_numpy``.
- ``thread_num=4`` on ``CPUPlace()``: Hogwild, each thread over its share
  of the files on the shared scope: every batch runs (a partial last batch
  of each share too), every sample once, the losses finite, the steps
  overlap in the executor, the parameters move; ``hogwild=False`` is the
  card's form (reader threads, one step at a time): every sample once.
- A stress run, more threads than cores, the interpreter switching every
  microsecond: every sample once, no result lost.
- ``DataFeedDesc`` from a data_feed.proto text or a list, as the JAX
  package's; the parameter-server surface raises, naming item 9; without
  a card ``AsyncExecutor()`` raises unless given ``CPUPlace()``.
"""
import importlib.util
import os
import sys
import threading

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import executor as texecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
spec = importlib.util.spec_from_file_location(
    "torch_recordio_programs", os.path.join(ROOT, "tools",
                                            "torch_recordio_programs.py"))
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)

W = tool.CTR_NARROW


def _desc(fluid, m):
    return fluid.DataFeedDesc(slots=m.feeds, batch_size=W["batch"])


def _persistables(m, scope):
    return {v.name: np.asarray(texecutor.as_numpy(scope.get(v.name)))
            for v in m.main.global_block().vars.values()
            if v.persistable and scope.get(v.name) is not None}


def test_one_thread_losses_match_the_jax_packages(tmp_path):
    samples = tool.ctr_samples(5, **W)
    path = str(tmp_path / "ctr.rec")
    tool.write_samples(tfluid, path, samples)
    losses = {}
    state = None
    for fluid in (jfluid, tfluid):
        m = tool.ctr_programs(fluid, **W)
        exe = fluid.AsyncExecutor(fluid.CPUPlace())
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(m.startup)
            if state is None:
                state = _persistables(m, scope)
                assert "fm_second" in state and "auc_0_stat_pos" in state
            else:
                tfluid.params_from_numpy(state, scope, "cpu")
            out = exe.run(m.main, data_feed=_desc(fluid, m), filelist=[path],
                          thread_num=1, fetch=[m.loss])
        losses[fluid] = [float(np.asarray(o[0]).reshape(-1)[0]) for o in out]
    assert len(losses[tfluid]) == W["samples"] // W["batch"]
    np.testing.assert_allclose(losses[tfluid], losses[jfluid], rtol=1e-6)


def _files(tmp_path, n_files, seed=6):
    samples = tool.ctr_samples(seed, **W)
    paths = tool.write_ctr_files(tfluid, str(tmp_path / "ctr"), samples,
                                 **dict(W, files=n_files))
    return samples, paths


def _rows(samples):
    return sorted(tuple(s[0].tolist()) + (float(s[1][0]),) for s in samples)


def _fed_rows(out):
    rows = []
    for ids, label, _ in out:
        rows += [tuple(i.tolist()) + (float(l[0]),)
                 for i, l in zip(ids, label)]
    return sorted(rows)


def _run(tmp_path, paths, thread_num, **kwargs):
    m = tool.ctr_programs(tfluid, **W)
    exe = tfluid.AsyncExecutor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(m.startup)
        before = _persistables(m, scope)
        out = exe.run(m.main, data_feed=_desc(tfluid, m), filelist=paths,
                      thread_num=thread_num,
                      fetch=["feat_ids", "label", m.loss], **kwargs)
        after = _persistables(m, scope)
    return out, before, after


def test_four_threads_train_hogwild_on_the_cpu(tmp_path):
    samples, paths = _files(tmp_path, 4)
    overlap = {"now": 0, "most": 0}
    lock = threading.Lock()
    real = tfluid.Executor._run_block

    def counted(self, *args, **kwargs):
        with lock:
            overlap["now"] += 1
            overlap["most"] = max(overlap["most"], overlap["now"])
        try:
            return real(self, *args, **kwargs)
        finally:
            with lock:
                overlap["now"] -= 1

    tfluid.Executor._run_block = counted
    try:
        out, before, after = _run(tmp_path, paths, 4)
    finally:
        tfluid.Executor._run_block = real
    # each file's 10 samples: a batch of 8 and one of 2
    assert len(out) == 8
    assert sorted(len(o[0]) for o in out) == [2] * 4 + [8] * 4
    assert _fed_rows(out) == _rows(samples)
    assert all(np.isfinite(o[2]).all() for o in out)
    assert overlap["most"] >= 2, "no two steps ran at once"
    assert np.abs(after["fc_0.w_0"] - before["fc_0.w_0"]).max() > 0


def test_reader_threads_feed_one_step_at_a_time(tmp_path):
    samples, paths = _files(tmp_path, 4)
    out, _, _ = _run(tmp_path, paths, 4, hogwild=False)
    assert len(out) == W["samples"] // W["batch"]
    assert _fed_rows(out) == _rows(samples)


def test_hogwild_stress_loses_no_step(tmp_path):
    samples, paths = _files(tmp_path, 8, seed=7)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out, _, _ = _run(tmp_path, paths, 2 * os.cpu_count())
    finally:
        sys.setswitchinterval(old)
    assert len(out) == 8            # one batch of 5 a file
    assert _fed_rows(out) == _rows(samples)


def test_data_feed_desc_reads_a_proto_text_as_the_jax_package(tmp_path):
    path = tmp_path / "data_feed.proto"
    path.write_text('name: "MultiSlotDataFeed"\nbatch_size: 2\n'
                    'multi_slot_desc {\n  slots {\n    name: "feat_ids"\n'
                    '    type: "uint64"\n  }\n  slots {\n'
                    '    name: "label"\n    type: "float"\n  }\n}\n')
    for fluid in (tfluid, jfluid):
        d = fluid.DataFeedDesc(str(path))
        assert d.slots == ["MultiSlotDataFeed", "feat_ids", "label"]
        d = fluid.DataFeedDesc(["feat_ids", "label"], batch_size=4)
        d.set_batch_size(16)
        d.set_use_slots(["feat_ids"])
        d.set_dense_slots(["label"])
        assert d.desc() == {"slots": ["feat_ids", "label"], "batch_size": 16}


DISTRIBUTED = {
    "config_distributed_nodes": lambda e: e.config_distributed_nodes(),
    "init_server": lambda e: e.init_server(""),
    "init_worker": lambda e: e.init_worker(""),
    "init_model": lambda e: e.init_model(),
    "save_model": lambda e: e.save_model("x"),
    "download_data": lambda e: e.download_data("a", "b"),
    "run_downpour": lambda e: e.run(tfluid.Program(), data_feed=object(),
                                    filelist=[], mode="downpour"),
}


@pytest.mark.parametrize("call", sorted(DISTRIBUTED))
def test_the_parameter_server_surface_raises_naming_item_9(call):
    exe = tfluid.AsyncExecutor(tfluid.CPUPlace())
    with pytest.raises(NotImplementedError, match="item 9"):
        DISTRIBUTED[call](exe)
    with pytest.raises(ValueError, match="config_distributed_nodes"):
        exe.get_instance()
    assert exe.stop() is None


def test_without_a_card_it_needs_the_cpu_place(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        tfluid.AsyncExecutor()
    # with no data feed, run is Executor.run
    m = tool.ctr_programs(tfluid, **W)
    exe, scope = tfluid.AsyncExecutor(tfluid.CPUPlace()), tfluid.Scope()
    assert exe.run(m.startup, scope=scope) == []
    assert scope.get("fm_second") is not None
