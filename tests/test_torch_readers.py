"""The in-process input pipeline of the port against the JAX package's on
the CPU: ``fluid.io.PyReader`` (each ``decorate_*``), ``layers.py_reader``
with ``read_file`` and ``Preprocessor``, ``fluid.DataFeeder`` (``feed``,
``feed_parallel``, ``decorate_reader``), ``paddle_tpu_torch.reader``'s
decorators and creators, the graph reader ops to ``fluid.EOFException``
and ``create_ctr_reader`` (tools/torch_input_programs.py builds the
programs). ``multiprocess_reader`` (a copy of the JAX package's, which
forks) is not run here: forking this multi-threaded test process could
deadlock.

- Feeds and batches are the JAX package's arrays exactly (the bucketed
  lengths too); losses of programs fed from the same state within 1e-5
  relative.
- The differences from the Paddle reference that both packages share
  (ROADMAP Queue 3), each pinned by an ``..._in_both_packages`` test: the
  random data generator layer's ``shapes`` attr, which its handler does
  not read; ``read`` over the py_reader and CTR readers, which have no
  ``next()``; ``read_file`` of a graph reader returning the reader
  variable; ``WeightNormParamAttr``, which applies no weight norm; and
  ``error_clip_callback``, which adds no clip op; ``open_files``, which
  writes ``filenames`` where the handlers read ``file_names``, so that
  the layer's reader reads nothing. ``reader.creator.recordio`` reads
  either package's record files.
- Item 2(i): ``fluid.name_scope`` marks the ops built inside it with the
  JAX package's ``name_scope`` attr; ``ErrorClipByValue`` appends the
  JAX package's clip op; ``NullGradientClipAttr`` passes the gradient.
"""
import importlib.util
import os
import random

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu.reader as jreader
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.reader as treader
from paddle_tpu_torch.fluid import data_feeder as tfeeder
from paddle_tpu.fluid import data_feeder as jfeeder

import torch_resnet_step as step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
spec = importlib.util.spec_from_file_location(
    "torch_input_programs", os.path.join(ROOT, "tools",
                                         "torch_input_programs.py"))
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)
spec = importlib.util.spec_from_file_location(
    "torch_recordio_programs", os.path.join(ROOT, "tools",
                                            "torch_recordio_programs.py"))
tool_rio = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool_rio)

TOL = 1e-5
PACKAGES = [tfluid, jfluid]


def _cpu(fluid):
    return fluid.Executor(fluid.CPUPlace())


def _f(v):
    return float(np.asarray(v).reshape(-1)[0])


def _start(fluid, m, state):
    scope = fluid.Scope()
    _cpu(fluid).run(m.startup, scope=scope)
    if state is None:
        return scope, {n: tfluid.executor.as_numpy(scope.get(n)).copy()
                       for n in scope._vars if scope.get(n) is not None}
    for n, v in state.items():
        scope.set(n, v if fluid is jfluid else torch.from_numpy(v.copy()))
    return scope, state


# ---- PyReader ---------------------------------------------------------------

def _resnet_losses(fluid, decorate, state=None):
    m, reader = tool.resnet_reader(fluid, **tool.RESNET_NARROW)
    decorate(reader)
    scope, state = _start(fluid, m, state)
    exe = _cpu(fluid)
    return [_f(exe.run(m.main, feed=f, fetch_list=[m.loss], scope=scope)[0])
            for f in reader], state


def _batches():
    return tool.image_batches(130, **tool.RESNET_NARROW)


DECORATE = {
    "sample_generator": lambda r: None,     # resnet_reader's own
    "batch_generator": lambda r: r.decorate_batch_generator(
        lambda: iter([[b["img"], b["label"]] for b in _batches()])),
    "tensor_provider": lambda r: r.decorate_tensor_provider(
        lambda: iter([[b["img"], b["label"]] for b in _batches()])),
    "sample_list_generator": lambda r: r.decorate_sample_list_generator(
        lambda: iter([list(zip(b["img"], b["label"])) for b in _batches()])),
    "paddle_reader": lambda r: r.decorate_paddle_reader(
        treader.batch(lambda: iter(zip(np.concatenate(
            [b["img"] for b in _batches()]), np.concatenate(
            [b["label"] for b in _batches()]))),
            tool.RESNET_NARROW["batch"])),
}


@pytest.mark.parametrize("how", sorted(DECORATE))
def test_py_reader_decorations_give_the_numpy_feeds(how):
    """Every decoration gives the same batches: the losses of a run to the
    reader's end equal those of the same batches fed as numpy."""
    got, state = _resnet_losses(tfluid, DECORATE[how])
    assert len(got) == tool.RESNET_NARROW["batches"]
    m, _ = tool.resnet_reader(tfluid, **tool.RESNET_NARROW)
    scope, _ = _start(tfluid, m, state)
    fed = [_f(_cpu(tfluid).run(m.main, feed=b, fetch_list=[m.loss],
                               scope=scope)[0]) for b in _batches()]
    np.testing.assert_allclose(got, fed, rtol=TOL)


def test_py_reader_trains_as_the_jax_package():
    """The JAX package's PyReader over the same sample generator, from the
    same state: the same losses."""
    got, state = _resnet_losses(tfluid, DECORATE["sample_generator"])
    want, _ = _resnet_losses(jfluid, DECORATE["sample_generator"], state)
    np.testing.assert_allclose(got, want, rtol=TOL)


def test_py_reader_restarts_after_its_end_and_is_fluid_io_py_reader():
    assert tfluid.io.PyReader is tfluid.layers.io.PyReader
    m, reader = tool.resnet_reader(tfluid, **tool.RESNET_NARROW)
    first = [f["label"].tolist() for f in reader]
    again = [f["label"].tolist() for f in reader]
    assert first == again and len(first) == tool.RESNET_NARROW["batches"]
    reader.start()
    reader.next()
    with pytest.raises(StopIteration):
        for _ in range(10):
            reader.next()


def test_sample_generator_keeps_a_partial_batch_without_drop_last():
    for fluid in PACKAGES:
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            x = fluid.layers.data(name="x", shape=[2], dtype="float32")
            r = fluid.io.PyReader(feed_list=[x], capacity=2)
        samples = lambda: ((np.full(2, i, np.float32),) for i in range(5))
        r.decorate_sample_generator(samples, batch_size=2, drop_last=False)
        assert [f["x"].shape[0] for f in r] == [2, 2, 1]
        r.decorate_sample_generator(samples, batch_size=2)
        assert [f["x"].shape[0] for f in r] == [2, 2]


# ---- py_reader -> read_file -> Preprocessor ---------------------------------

def test_py_reader_preprocessor_chain_matches_jax():
    losses = {}
    state = None
    for fluid in PACKAGES:
        m, reader = tool.py_reader_chain(fluid, **tool.SLOTS_NARROW)
        reader.decorate_tensor_provider(
            lambda: iter(tool.slot_batches(0, **tool.SLOTS_NARROW)))
        scope, state = _start(fluid, m, state)
        exe = _cpu(fluid)
        losses[fluid] = [_f(exe.run(m.main, feed=f, fetch_list=[m.loss],
                                    scope=scope)[0]) for f in reader]
    assert step.signature(tool.py_reader_chain(jfluid, **tool.SLOTS_NARROW)[
        0].main) == step.signature(tool.py_reader_chain(
            tfluid, **tool.SLOTS_NARROW)[0].main)
    assert len(losses[tfluid]) == tool.SLOTS_NARROW["batches"]
    np.testing.assert_allclose(losses[tfluid], losses[jfluid], rtol=TOL)


def test_preprocessor_ops_sit_in_the_main_block():
    m, reader = tool.py_reader_chain(tfluid, **tool.SLOTS_NARROW)
    ops = [op.type for op in m.main.global_block().ops]
    assert ops[0] == "scale" and len(m.main.blocks) == 1
    assert tfluid.layers.double_buffer(reader) is reader
    assert tfluid.layers.read_file(reader) == reader.feed_list


# ---- DataFeeder -------------------------------------------------------------

@pytest.mark.parametrize("buckets", [None, [4, 12], False],
                         ids=["powers_of_two", "listed", "exact"])
def test_bucketed_len_is_the_jax_packages(buckets):
    for n in [1, 3, 7, 8, 9, 12, 13, 30, 64, 65]:
        assert tfeeder._bucketed_len(n, buckets) == \
            jfeeder._bucketed_len(n, buckets)


def _feeders(**kw):
    out = []
    for fluid in PACKAGES:
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            w = fluid.layers.data(name="w", shape=[1], dtype="int64",
                                  lod_level=1)
            y = fluid.layers.data(name="y", shape=[1], dtype="float32")
            out.append(fluid.DataFeeder([w, y], fluid.CPUPlace(),
                                        program=main, **kw))
    return out


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype, k


@pytest.mark.parametrize("buckets", [None, [4, 12], False],
                         ids=["powers_of_two", "listed", "exact"])
def test_data_feeder_feeds_the_jax_packages_arrays(buckets):
    t, j = _feeders(seq_buckets=buckets)
    batch = tool.ragged_samples(0, **tool.LSTM_NARROW)[0]
    got = t.feed([(ids[:, None], [float(lab[0])]) for ids, lab in batch])
    _same(got, j.feed([(ids[:, None], [float(lab[0])])
                       for ids, lab in batch]))
    assert got["w@LEN"].tolist() == [len(ids) for ids, _ in batch]


def test_feed_parallel_and_decorate_reader_match_jax():
    t, j = _feeders()
    batches = [[(np.arange(k + 1)[:, None], [0.5 * k]) for k in range(n)]
               for n in (2, 4, 3)]
    _same(t.feed_parallel(batches[:2]), j.feed_parallel(batches[:2]))
    got = list(t.decorate_reader(lambda: iter(batches), num_places=2)())
    want = list(j.decorate_reader(lambda: iter(batches), num_places=2)())
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        _same(a, b)
    with pytest.raises(ValueError, match="mid-stream"):
        list(t.decorate_reader(lambda: iter(batches[::-1]),
                               num_places=2)())
    with pytest.raises(ValueError, match="drop_last"):
        list(t.decorate_reader(lambda: iter(batches), num_places=2,
                               drop_last=False)())


def test_decorate_reader_counts_the_places_devices():
    """CPUPlace: one device, so no batch is held back; a CUDAPlace counts
    torch.cuda.device_count()."""
    t, _ = _feeders()
    odd = [[(np.arange(2)[:, None], [1.0])] * 3]
    assert len(list(t.decorate_reader(lambda: iter(odd))())) == 1
    assert tfeeder._device_count(tfluid.CUDAPlace(0)) == \
        torch.cuda.device_count()
    assert tfeeder._device_count(tfluid.CPUPlace()) == 1


def test_stacked_lstm_trains_from_the_data_feeder_as_jax():
    losses, state = {}, None
    for fluid in PACKAGES:
        m, feeder = tool.lstm_feeder(fluid, fluid.CPUPlace(),
                                     **tool.LSTM_NARROW)
        scope, state = _start(fluid, m, state)
        exe = _cpu(fluid)
        losses[fluid] = []
        for batch in tool.ragged_samples(0, **tool.LSTM_NARROW):
            feed = feeder.feed(batch)
            assert feed["words"].shape[1] == tfeeder._bucketed_len(
                max(len(ids) for ids, _ in batch), None)
            losses[fluid].append(_f(exe.run(m.main, feed=feed,
                                            fetch_list=[m.loss],
                                            scope=scope)[0]))
    np.testing.assert_allclose(losses[tfluid], losses[jfluid], rtol=TOL)


# ---- paddle_tpu_torch.reader ------------------------------------------------

def _src(n=7):
    return lambda: iter([(i, i * i) for i in range(n)])


def _run(r):
    return [tuple(np.asarray(v).tolist() for v in x)
            if isinstance(x, tuple) else np.asarray(x).tolist() for x in r()]


def _seeded(r):
    random.seed(7)
    return _run(r)


READER_CASES = {
    "batch": lambda R: R.batch(_src(), 3),
    "batch_drop_last": lambda R: R.batch(_src(), 3, drop_last=True),
    "shuffle": lambda R: R.shuffle(_src(), 3),
    "chain": lambda R: R.chain(_src(2), _src(3)),
    "compose": lambda R: R.compose(_src(3), _src(3)),
    "compose_unaligned": lambda R: R.compose(
        _src(2), _src(3), check_alignment=False),
    "map_readers": lambda R: R.map_readers(lambda a, b: a[0] + b[1],
                                           _src(), _src()),
    "buffered": lambda R: R.buffered(_src(), 2),
    "firstn": lambda R: R.firstn(_src(), 4),
    "cache": lambda R: R.cache(_src()),
    "xmap_readers_ordered": lambda R: R.xmap_readers(
        lambda s: s[0] * 10, _src(), 3, 4, order=True),
    "np_array": lambda R: R.creator.np_array(np.arange(6).reshape(3, 2)),
    "fake": lambda R: R.Fake()(_src(), 3),
}


@pytest.mark.parametrize("case", sorted(READER_CASES))
def test_reader_decorators_match_the_jax_packages(case):
    got = _seeded(READER_CASES[case](treader))
    assert got == _seeded(READER_CASES[case](jreader))
    assert got


def test_unordered_xmap_reader_gives_the_same_samples():
    t = treader.xmap_readers(lambda s: s[0], _src(), 2, 4)
    assert sorted(_run(t)) == list(range(7))


def test_text_file_and_pipe_readers(tmp_path):
    path = tmp_path / "lines.txt"
    path.write_text("a b\nc\n\nd\n")
    for R in (treader, jreader):
        assert list(R.creator.text_file(str(path))()) == ["a b", "c", "",
                                                           "d"]
        pipe = R.PipeReader("cat %s" % path)
        assert list(pipe.get_line()) == ["a b", "c", "", "d"]


def test_recordio_creator_waits_for_item_9(tmp_path):
    """reader.creator.recordio reads the record files that either package
    wrote (a comma-separated string or a list), in order; the same samples
    as the JAX package's creator. (The name is from before record files
    were ported, when the port's creator raised.)"""
    samples = [[np.arange(3, dtype=np.float32) + i, np.array([i], np.int64)]
               for i in range(5)]
    paths = []
    for R in (treader, jreader):
        paths.append(str(tmp_path / ("%s.rec" % R.__name__)))
        R.recordio.convert_reader_to_recordio_file(paths[-1],
                                                   lambda: iter(samples))
    for R in (treader, jreader):
        got = list(R.creator.recordio(",".join(paths))())
        assert len(got) == 2 * len(samples)
        for g, w in zip(got, samples + samples):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    import paddle_tpu_torch
    assert paddle_tpu_torch.batch is treader.batch


# ---- the graph readers ------------------------------------------------------

def test_graph_reader_chain_matches_jax_and_ends_in_eof():
    """The random generator (seed 0) through shuffle, batch, multi-pass and
    double buffer: the same batches in both packages; over a finite
    source, the same count before fluid.EOFException."""
    sums, counts = {}, {}
    for fluid in PACKAGES:
        m = tool.reader_chain(fluid, **tool.READERS_NARROW)
        scope = fluid.Scope()
        random.seed(3)
        sums[fluid] = [_f(_cpu(fluid).run(m.main, fetch_list=[m.loss],
                                          scope=scope)[0])
                       for _ in range(4)]
        scope = fluid.Scope()
        scope.set(m.extra["source"], tool.finite_source(
            fluid, tool.reader_samples(0, 5, **tool.READERS_NARROW)))
        n = 0
        with pytest.raises(fluid.EOFException):
            for _ in range(20):
                _cpu(fluid).run(m.main, fetch_list=[m.loss], scope=scope)
                n += 1
        counts[fluid] = n
    np.testing.assert_allclose(sums[tfluid], sums[jfluid], rtol=TOL)
    # 5 samples, batches of 2 (the last partial one dropped), 2 passes
    assert counts[tfluid] == counts[jfluid] == 4
    assert step.signature(tool.reader_chain(
        tfluid, **tool.READERS_NARROW).main) == step.signature(
            tool.reader_chain(jfluid, **tool.READERS_NARROW).main)


def test_ctr_reader_batches_match_jax(tmp_path):
    path = str(tmp_path / "ctr.txt")
    rows = tool.write_ctr_file(path, 0, **tool.CTR_FILE_NARROW)
    out = {}
    for fluid in PACKAGES:
        m = tool.ctr_reader_program(fluid, path, **tool.CTR_FILE_NARROW)
        scope = fluid.Scope()
        _cpu(fluid).run(m.main, scope=scope)
        reader = scope.get(m.extra["reader"])
        out[fluid] = []
        with pytest.raises(fluid.EOFException):
            while True:
                out[fluid].append(reader.read())
    assert len(out[tfluid]) == 3
    for a, b in zip(out[tfluid], out[jfluid]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    labels = np.concatenate([b[0] for b in out[tfluid]]).reshape(-1)
    assert labels.tolist() == [r[0] for r in rows]
    first = out[tfluid][0][1]
    assert first[0, :len(rows[0][1]["1"])].tolist() == rows[0][1]["1"]


# ---- the shared differences from the reference (ROADMAP Queue 3) ------------

def test_random_data_generator_layer_shapes_attr_in_both_packages():
    """The layer writes ``shapes``; the handler reads ``shape_concat`` and
    ``ranks``: the reader yields empty sample lists, so a read fills
    nothing and a fetch of its output raises."""
    from importlib import import_module
    for fluid in PACKAGES:
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            r = fluid.layers.random_data_generator(0.0, 1.0, [[2, 3]], [0])
            blk = main.global_block()
            x = blk.create_var(name="rx", shape=(2, 3), dtype="float32")
            blk.append_op(type="read", inputs={"Reader": [r]},
                          outputs={"Out": [x]}, attrs={})
        op = [o for o in blk.ops
              if o.type == "create_random_data_generator"][0]
        assert op.attr("shapes") == [[2, 3]] and \
            op.attr("shape_concat") is None
        with pytest.raises(ValueError, match="not produced"):
            _cpu(fluid).run(main, fetch_list=[x], scope=fluid.Scope())
        VarType = import_module(fluid.__name__ + ".core_types").VarType
        assert r.type == VarType.READER
        assert fluid.layers.read_file(r) is r


@pytest.mark.parametrize("kind", ["py_reader", "ctr"])
def test_read_op_over_readers_without_next_in_both_packages(kind, tmp_path):
    from importlib import import_module
    path = str(tmp_path / "ctr.txt")
    tool.write_ctr_file(path, 0, **tool.CTR_FILE_NARROW)
    for fluid in PACKAGES:
        VarType = import_module(fluid.__name__ + ".core_types").VarType
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            x = fluid.layers.data(name="x", shape=[2], dtype="float32")
            blk = main.global_block()
            r = blk.create_var(name="rr", type=VarType.READER,
                               persistable=True)
            if kind == "py_reader":
                reader = fluid.io.PyReader(feed_list=[x], capacity=2,
                                           name="queue_%s" % id(fluid))
                reader.decorate_tensor_provider(
                    lambda: iter([[np.ones((1, 2), np.float32)]]))
                blk.append_op(type="create_py_reader", inputs={},
                              outputs={"Out": [r]},
                              attrs={"queue_name": "queue_%s" % id(fluid)})
            else:
                blk.append_op(type="create_ctr_reader", inputs={},
                              outputs={"Out": [r]},
                              attrs={"file_list": [path], "batch_size": 2,
                                     "slots": ["1"]})
            out = blk.create_var(name="ro", dtype="float32")
            blk.append_op(type="read", inputs={"Reader": [r]},
                          outputs={"Out": [out]}, attrs={})
        with pytest.raises(AttributeError, match="next"):
            _cpu(fluid).run(main, scope=fluid.Scope())


def test_open_files_attr_and_the_ports_raise_in_both_packages(tmp_path):
    """layers.open_files writes the attr ``filenames`` in both packages
    and the open_files handlers read ``file_names``: a program built by
    the layer reads nothing (the first read raises EOFException) in
    either package (ROADMAP Queue 3). (The name is from before record
    files were ported, when the port's layer raised.)"""
    path = str(tmp_path / "a.recordio")
    tool_rio.write_samples(tfluid, path, tool_rio.counting_samples(4))
    for fluid in PACKAGES:
        m = tool_rio.open_files_program(fluid, [path], layer=True)
        op = m.main.global_block().ops[0]
        assert op.type == "open_files"
        assert op.attr("filenames") == [path]
        assert op.attr("file_names") is None
        with pytest.raises(fluid.EOFException):
            _cpu(fluid).run(m.main, fetch_list=[m.loss],
                            scope=fluid.Scope())


def test_weight_norm_param_attr_applies_no_norm_in_both_packages():
    types = []
    for fluid in PACKAGES:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data(name="x", shape=[3], dtype="float32")
            attr = fluid.WeightNormParamAttr(dim=0, name="wn_w")
            fluid.layers.fc(input=x, size=2, param_attr=attr)
        assert attr.dim == 0 and attr.name == "wn_w"
        types.append([op.type for op in main.global_block().ops])
        assert main.global_block().var("wn_w").shape == (3, 2)
    assert types[0] == types[1] == ["mul", "elementwise_add"]


def test_error_clip_callback_adds_no_op_in_both_packages():
    progs = []
    for fluid in PACKAGES:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data(name="x", shape=[3], dtype="float32")
            h = fluid.layers.fc(input=x, size=2)
            h.error_clip = fluid.clip.ErrorClipByValue(0.1)
            loss = fluid.layers.mean(h)
            fluid.optimizer.SGD(0.1).minimize(loss)
        assert "clip" not in [op.type for op in main.global_block().ops]
        progs.append(main)
    assert step.signature(progs[0]) == step.signature(progs[1])


# ---- item 2(i) --------------------------------------------------------------

def test_name_scope_marks_the_ops_as_the_jax_package_does():
    progs = []
    for fluid in PACKAGES:
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()), \
                fluid.unique_name.guard():
            x = fluid.layers.data(name="x", shape=[3], dtype="float32")
            with fluid.name_scope("enc"):
                with fluid.name_scope("ffn"):
                    y = fluid.layers.scale(x, 2.0)
                z = fluid.layers.scale(y, 3.0)
            fluid.layers.scale(z, 4.0)
        progs.append(main)
    ops = progs[0].global_block().ops
    assert [op.attrs.get("name_scope") for op in ops] == ["enc/ffn", "enc",
                                                         None]
    assert step.signature(progs[0]) == step.signature(progs[1])


def test_error_clip_and_null_gradient_clip_attrs():
    for fluid in PACKAGES:
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            g = main.global_block().create_var(name="g@GRAD", shape=[2],
                                               dtype="float32")
            clip = fluid.clip.ErrorClipByValue(max=0.5)
            assert (clip.min, clip.max) == (-0.5, 0.5)
            clip._append_clip_op(main.global_block(), g.name)
            assert isinstance(clip, fluid.clip.BaseErrorClipAttr)
            assert fluid.clip.NullGradientClipAttr()._create_operators(
                "p", "g") == ("p", "g")
        op = main.global_block().ops[0]
        assert op.type == "clip" and op.attr("min") == -0.5
        out, = _cpu(fluid).run(main, feed={"g@GRAD": np.array(
            [2.0, -0.1], np.float32)}, fetch_list=["g@GRAD"],
            scope=fluid.Scope())
        np.testing.assert_array_equal(np.asarray(out),
                                      np.array([0.5, -0.1], np.float32))
