"""The input-pipeline and host-op programs, built on whichever ``fluid``
module the caller passes: the port's (``paddle_tpu_torch.fluid``) or the
JAX package's (``paddle_tpu.fluid``). The same code gives the same
program on both, op for op.

    import paddle_tpu_torch.fluid as fluid
    tool = <this file, loaded by path>
    m, reader = tool.resnet_reader(fluid, **tool.RESNET_NARROW)
    exe = fluid.Executor(fluid.CPUPlace()); exe.run(m.startup)
    for feed in reader:
        exe.run(m.main, feed=feed, fetch_list=[m.loss])

Programs return ``Model(main, startup, loss, out, feeds, extra)``; data is
seeded and synthetic (the ImageNet, IMDB and Criteo files are not in the
repository).

The input pipeline:

- ``resnet_reader``: bench.py's ResNet-50 leg (the package's
  ``models/resnet.py``, 224, 1,000 classes, Momentum(0.01, 0.9)) fed by a
  ``fluid.io.PyReader`` (capacity 64) over ``decorate_sample_generator``
  at batch 64: ``batches`` batches of seeded samples (``image_samples``),
  then the reader's end.
- ``lstm_feeder``: the stacked dynamic LSTM (tools/
  torch_fusion_programs.py's ``stacked_lstm``: models/stacked_lstm.py at
  fluid_benchmark's widths, Adam) fed by a ``fluid.DataFeeder`` over
  ragged samples of lengths 1-64 (``ragged_samples``), each batch padded
  to its bucketed length.
- ``py_reader_chain``: ``layers.py_reader`` -> ``read_file`` -> a
  ``Preprocessor`` (scale and shift of the image, the label as it is) ->
  fc -> softmax cross-entropy, SGD; ``slot_batches`` feeds it.
- ``reader_chain``: the graph reader ops, appended op by op:
  ``create_random_data_generator`` (its handler's ``shape_concat`` and
  ``ranks`` attrs, as tests/test_graph_readers.py builds it; the layer
  writes ``shapes``, which the handler ignores), then the shuffle, batch,
  multi-pass and double-buffer readers, then ``read`` and a sum. The
  random generator never ends; ``finite_source`` names the source reader
  variable into which a caller puts a finite reader to reach the end
  (``fluid.EOFException``), as a recordio file reader would end.
- ``ctr_reader_program``: ``create_ctr_reader`` over an svm-format file
  that ``write_ctr_file`` writes (26 slots). The ``read`` op calls the
  reader's ``next()``, which the CTR reader lacks (both packages): the
  reader object is pulled with ``read()`` instead.

The host ops:

- ``go_program``: a linear regressor ([64, 256] · [256, 128]) with Adam
  whose main program first spawns a ``layers.Go`` block that waits for
  ``release`` (a ``py_func`` host op) and then copies the regressor's
  weight, and a second block that multiplies its input through the
  weight; the parent's Adam step after them updates the weight in place
  on the card (the fused Adam kernel).
- ``split_merge_program``: DeepFM's ids (4,096 x 26 = 106,496 at full
  width, ``ids_batch``) through ``split_ids`` to 4 shards, each shard's
  rows looked up in DeepFM's [100,000, 10] table, ``merge_ids`` back: the
  lookup of the ids themselves.
- ``py_func_programs``: x [64, 256] -> fc 256 -> an activation -> fc 1
  -> square error, SGD; the activation is tanh through ``layers.py_func``
  in numpy with its backward (``use_py_func``) or ``layers.tanh``.
- ``combine_programs``: ``save_combine`` of the named variables into one
  file and ``load_combine`` back (the JAX package's ``.npz`` format).
- ``misc_program``: ``delete_var`` of an intermediate and ``fake_init``
  of a table; ``engine_program``: a ``tensorrt_engine`` or
  ``ngraph_engine`` op, which raises.

``*_NARROW`` hold the CPU tests' widths.
"""
import collections
import importlib
import importlib.util
import os

import numpy as np

Model = collections.namedtuple("Model", "main startup loss out feeds extra")


def _module(fluid, name):
    return importlib.import_module(
        fluid.__name__.split(".")[0] + ".models." + name)


def _fusion_tool():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_fusion_programs.py")
    spec = importlib.util.spec_from_file_location("torch_fusion_programs",
                                                  path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


# ---- ResNet-50 fed by a PyReader --------------------------------------------

RESNET = dict(dataset="flowers", depth=50, image=[3, 224, 224], classes=1000,
              batch=64, batches=8, capacity=64)
RESNET_NARROW = dict(dataset="cifar10", depth=8, image=[3, 32, 32],
                     classes=10, batch=2, batches=3, capacity=4)


def image_samples(seed, **widths):
    """A sample generator creator: batch * batches (image, label) samples,
    uniform [0, 1) images and uniform labels, drawn as it is iterated."""
    w = dict(RESNET, **widths)

    def gen():
        rng = np.random.RandomState(seed)
        for _ in range(w["batch"] * w["batches"]):
            yield (rng.rand(*w["image"]).astype(np.float32),
                   rng.randint(0, w["classes"], (1,)).astype(np.int64))
    return gen


def resnet_reader(fluid, seed=130, **widths):
    """(Model, its PyReader over image_samples(seed + 1))."""
    w = dict(RESNET, **widths)
    R = _module(fluid, "resnet")
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, loss, acc = R.build(dataset=w["dataset"], depth=w["depth"],
                               class_dim=w["classes"])
        fluid.optimizer.Momentum(learning_rate=0.01,
                                 momentum=0.9).minimize(loss)
        block = main.global_block()
        reader = fluid.io.PyReader(
            feed_list=[block.var("img"), block.var("label")],
            capacity=w["capacity"])
    reader.decorate_sample_generator(image_samples(seed + 1, **w),
                                     batch_size=w["batch"])
    return Model(main, startup, loss, acc, ["img", "label"],
                 {"widths": w}), reader


def image_batches(seed, **widths):
    """The batches resnet_reader's reader gives, stacked as numpy feeds."""
    w = dict(RESNET, **widths)
    samples = list(image_samples(seed + 1, **w)())
    out = []
    for k in range(w["batches"]):
        part = samples[k * w["batch"]:(k + 1) * w["batch"]]
        out.append({"img": np.stack([s[0] for s in part]),
                    "label": np.stack([s[1] for s in part])})
    return out


# ---- the stacked LSTM fed by a DataFeeder -----------------------------------

LSTM = dict(batch=64, batches=4, max_len=64)
# with the stacked LSTM's narrow widths (tools/torch_fusion_programs.py)
LSTM_NARROW = dict(batch=4, batches=3, max_len=10, vocab=40, seq=10, emb=6,
                   hidden=5)


def ragged_samples(seed, **widths):
    """Batches of [(ids of length 1 to max_len, [label])] sample lists:
    the lengths uniform, the ids uniform below the vocab."""
    w = dict(LSTM, **widths)
    f = dict(_fusion_tool().STACKED, **widths)
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(w["batches"]):
        batch = []
        for _ in range(w["batch"]):
            n = rng.randint(1, w["max_len"] + 1)
            batch.append((rng.randint(0, f["vocab"], (n,)).astype(np.int64),
                          [int(rng.randint(0, f["classes"]))]))
        out.append(batch)
    return out


def lstm_feeder(fluid, place, seed=131, **widths):
    """(Model, its DataFeeder): the stacked LSTM with Adam and a feeder of
    its words (ragged) and label."""
    m = _fusion_tool().stacked_lstm(fluid, seed=seed, **{
        k: v for k, v in widths.items() if k not in LSTM})
    block = m.main.global_block()
    feeder = fluid.DataFeeder([block.var("words"), block.var("label")],
                              place, program=m.main)
    return m, feeder


# ---- py_reader -> read_file -> Preprocessor ---------------------------------

SLOTS = dict(batch=64, features=256, classes=10, batches=4)
SLOTS_NARROW = dict(batch=3, features=4, classes=3, batches=3)


def py_reader_chain(fluid, seed=132, **widths):
    """(Model, its py_reader): the Preprocessor scales the features by 2
    and shifts them by -1; fc to the classes, softmax cross-entropy,
    SGD(0.01)."""
    w = dict(SLOTS, **widths)
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        reader = L.py_reader(capacity=w["batches"],
                             shapes=[[-1, w["features"]], [-1, 1]],
                             dtypes=["float32", "int64"], name="slots")
        reader = L.double_buffer(reader)
        pre = L.Preprocessor(reader)
        with pre.block():
            x, y = pre.inputs()
            pre.outputs(L.scale(x, scale=2.0, bias=-1.0), y)
        x, y = pre()
        logits = L.fc(input=x, size=w["classes"])
        loss = L.mean(L.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return Model(main, startup, loss, logits,
                 [v.name for v in reader.feed_list], {"widths": w}), reader


def slot_batches(seed, **widths):
    """The py_reader's batches: [features uniform [0, 1), labels]."""
    w = dict(SLOTS, **widths)
    rng = np.random.RandomState(seed)
    return [[rng.rand(w["batch"], w["features"]).astype(np.float32),
             rng.randint(0, w["classes"], (w["batch"], 1)).astype(np.int64)]
            for _ in range(w["batches"])]


# ---- the graph reader chain -------------------------------------------------

READERS = dict(shape=[8, 16], buffer=16, batch=4, passes=2)
READERS_NARROW = dict(shape=[2, 3], buffer=4, batch=2, passes=2)


def reader_chain(fluid, **widths):
    """The chain's program: the source reader variable ``extra["source"]``,
    the read op's output ``out`` (a [batch] + shape sample batch) and
    ``loss`` its sum."""
    from importlib import import_module
    VarType = import_module(fluid.__name__ + ".core_types").VarType
    w = dict(READERS, **widths)
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        blk = main.global_block()

        def reader(name, op_type, under, attrs):
            r = blk.create_var(name=name, type=VarType.READER,
                               persistable=True)
            blk.append_op(type=op_type, inputs={"UnderlyingReader": [under]}
                          if under is not None else {},
                          outputs={"Out": [r]}, attrs=attrs)
            return r
        src = reader("random_source", "create_random_data_generator", None,
                     {"shape_concat": list(w["shape"]),
                      "ranks": [len(w["shape"])], "low": 0.0, "high": 1.0})
        r = reader("shuffled", "create_shuffle_reader", src,
                   {"buffer_size": w["buffer"]})
        r = reader("batched", "create_batch_reader", r,
                   {"batch_size": w["batch"]})
        r = reader("passes", "create_multi_pass_reader", r,
                   {"pass_num": w["passes"]})
        r = reader("buffered", "create_double_buffer_reader", r, {})
        out = blk.create_var(name="chain_sample",
                             shape=[w["batch"]] + list(w["shape"]),
                             dtype="float32")
        blk.append_op(type="read", inputs={"Reader": [r]},
                      outputs={"Out": [out]}, attrs={})
        loss = fluid.layers.reduce_sum(out)
    return Model(main, None, loss, out, [], {"widths": w,
                                             "source": src.name})


def finite_source(fluid, samples):
    """A graph reader over `samples` (lists of arrays) that ends after
    them: the package's own ``_GraphReader``, as a file reader makes."""
    host_ops = importlib.import_module(fluid.__name__ + ".host_ops")
    return host_ops._GraphReader(lambda: iter(samples))


def reader_samples(seed, n, **widths):
    w = dict(READERS, **widths)
    rng = np.random.RandomState(seed)
    return [[rng.rand(*w["shape"]).astype(np.float32)] for _ in range(n)]


# ---- create_ctr_reader ------------------------------------------------------

CTR_FILE = dict(rows=4096, slots=26, max_len=8, vocab=100000, batch=1024)
CTR_FILE_NARROW = dict(rows=7, slots=3, max_len=3, vocab=20, batch=3)


def write_ctr_file(path, seed, **widths):
    """An svm-format file: 'label slot:feasign ...', each slot 1 to
    max_len feasigns below vocab, slots named 1..slots; returns the rows
    as (label, {slot: [feasigns]})."""
    w = dict(CTR_FILE, **widths)
    rng = np.random.RandomState(seed)
    rows = []
    with open(path, "w") as f:
        for _ in range(w["rows"]):
            label = int(rng.rand() < 0.25)
            feats = {}
            toks = [str(label)]
            for s in range(1, w["slots"] + 1):
                ids = rng.randint(0, w["vocab"],
                                  rng.randint(1, w["max_len"] + 1))
                feats[str(s)] = [int(i) for i in ids]
                toks.extend("%d:%d" % (s, i) for i in ids)
            rows.append((label, feats))
            f.write(" ".join(toks) + "\n")
    return rows


def ctr_reader_program(fluid, path, **widths):
    """A create_ctr_reader op over `path`: the reader variable is
    ``extra["reader"]``."""
    from importlib import import_module
    VarType = import_module(fluid.__name__ + ".core_types").VarType
    w = dict(CTR_FILE, **widths)
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        blk = main.global_block()
        r = blk.create_var(name="ctr_reader", type=VarType.READER,
                           persistable=True)
        blk.append_op(type="create_ctr_reader", inputs={},
                      outputs={"Out": [r]},
                      attrs={"file_list": [path], "batch_size": w["batch"],
                             "slots": [str(s) for s in
                                       range(1, w["slots"] + 1)]})
    return Model(main, None, None, None, [], {"widths": w,
                                              "reader": r.name})


# ---- Go blocks --------------------------------------------------------------

GO = dict(batch=64, features=256, out=128)
GO_NARROW = dict(batch=3, features=4, out=3)


def go_program(fluid, release, seed=133, **widths):
    """x [batch, features] · ``go_w`` [features, out] -> square error, Adam
    (the fused Adam kernel takes go_w at full width and updates it in
    place on the card); before them two Go blocks: the first waits for
    ``release()`` (a py_func) and then copies go_w (``extra["snapshot"]``);
    the second writes x · go_w (``extra["product"]``)."""
    w = dict(GO, **widths)
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = L.data(name="x", shape=[w["features"]], dtype="float32")
        y = L.data(name="y", shape=[w["out"]], dtype="float32")
        weight = L.create_parameter([w["features"], w["out"]], "float32",
                                    name="go_w")
        released = main.global_block().create_var(
            name="go_released", shape=[1], dtype="float32")
        with L.Go().block():
            L.py_func(lambda: (release(), np.ones([1], np.float32))[1],
                      [], released)
            snap = L.scale(weight, scale=1.0)
        with L.Go().block():
            prod = L.matmul(x, weight)
        pred = L.matmul(x, weight)
        loss = L.mean(L.square_error_cost(pred, y))
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return Model(main, startup, loss, pred, ["x", "y"],
                 {"widths": w, "snapshot": snap.name,
                  "product": prod.name, "weight": "go_w"})


def go_batch(seed, **widths):
    w = dict(GO, **widths)
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(w["batch"], w["features"]).astype(np.float32),
            "y": rng.randn(w["batch"], w["out"]).astype(np.float32)}


# ---- split_ids / merge_ids --------------------------------------------------

SPLIT = dict(ids_batch=4096 * 26, vocab=100000, emb=10, shards=4)
SPLIT_NARROW = dict(ids_batch=23, vocab=30, emb=3, shards=4)


def split_merge_program(fluid, seed=134, **widths):
    """ids -> split_ids (``shards`` outputs) -> each shard's rows of the
    table -> merge_ids; ``out`` the merged rows, ``extra["direct"]`` the
    table's rows of the ids themselves, ``extra["shards"]`` the shards."""
    w = dict(SPLIT, **widths)
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        helper = fluid.layer_helper.LayerHelper("split_merge")
        blk = main.global_block()
        ids = L.data(name="ids", shape=[w["ids_batch"], 1], dtype="int64",
                     append_batch_size=False)
        table = fluid.ParamAttr(name="split_table")
        shards = [helper.create_variable_for_type_inference("int64")
                  for _ in range(w["shards"])]
        blk.append_op(type="split_ids", inputs={"Ids": [ids]},
                      outputs={"Out": shards})
        rows = [L.embedding(input=s, size=[w["vocab"], w["emb"]],
                            param_attr=table) for s in shards]
        merged = helper.create_variable_for_type_inference("float32")
        blk.append_op(type="merge_ids", inputs={"Ids": [ids], "X": rows},
                      outputs={"Out": [merged]})
        direct = L.embedding(input=ids, size=[w["vocab"], w["emb"]],
                             param_attr=table)
    return Model(main, startup, None, merged, ["ids"],
                 {"widths": w, "direct": direct.name,
                  "shards": [s.name for s in shards]})


def split_ids_batch(seed, **widths):
    """DeepFM's ids: uniform below the vocab."""
    w = dict(SPLIT, **widths)
    rng = np.random.RandomState(seed)
    return {"ids": rng.randint(0, w["vocab"], (w["ids_batch"], 1)).astype(
        np.int64)}


def merge_in_id_order(ids, shard_rows):
    """merge_ids_op.h's loop in numpy: row j is the next unread row of
    shard ids[j] % N."""
    n = len(shard_rows)
    out = np.zeros((ids.shape[0], shard_rows[0].shape[-1]),
                   shard_rows[0].dtype)
    counters = [0] * n
    for j, idv in enumerate(ids.reshape(-1)):
        s = int(idv) % n
        out[j] = shard_rows[s][counters[s]]
        counters[s] += 1
    return out


# ---- py_func in a training step ---------------------------------------------

PYFUNC = dict(batch=64, features=256, hidden=256)
PYFUNC_NARROW = dict(batch=3, features=4, hidden=5)


def _np_tanh(v):
    return np.tanh(v)


def py_func_programs(fluid, use_py_func, seed=135, **widths):
    """The regressor with its activation tanh through py_func (numpy,
    forward and backward; the backward skips the input x) or layers.tanh;
    the parameters named so that the two share them."""
    w = dict(PYFUNC, **widths)
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = L.data(name="x", shape=[w["features"]], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        h = L.fc(input=x, size=w["hidden"],
                 param_attr=fluid.ParamAttr(name="pf_w1"),
                 bias_attr=fluid.ParamAttr(name="pf_b1"))
        if use_py_func:
            t = main.global_block().create_var(
                name="pf_act", shape=[-1, w["hidden"]], dtype="float32")
            L.py_func(_np_tanh, h, t, backward_func=_np_tanh_grad_skip,
                      skip_vars_in_backward_input=[h])
        else:
            t = L.tanh(h)
        pred = L.fc(input=t, size=1, param_attr=fluid.ParamAttr(name="pf_w2"),
                    bias_attr=fluid.ParamAttr(name="pf_b2"))
        loss = L.mean(L.square_error_cost(pred, y))
        fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return Model(main, startup, loss, pred, ["x", "y"], {"widths": w})


def _np_tanh_grad_skip(out, dout):
    """tanh's backward given (out, dout): the input is skipped."""
    return dout * (1.0 - out * out)


def py_func_batch(seed, **widths):
    w = dict(PYFUNC, **widths)
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(w["batch"], w["features"]).astype(np.float32),
            "y": rng.randn(w["batch"], 1).astype(np.float32)}


# ---- save_combine / load_combine --------------------------------------------

def combine_programs(fluid, names, shapes, dtypes, path):
    """(save program, load program): one save_combine of `names` into
    `path`, one load_combine of them back."""
    progs = []
    for op_type, slot in (("save_combine", "inputs"),
                          ("load_combine", "outputs")):
        prog = fluid.Program()
        with fluid.program_guard(prog, fluid.Program()):
            blk = prog.global_block()
            for n, s, d in zip(names, shapes, dtypes):
                blk.create_var(name=n, shape=list(s), dtype=d,
                               persistable=True)
            io = {"X": list(names)} if slot == "inputs" else \
                {"Out": list(names)}
            blk.append_op(type=op_type, **{slot: io},
                          attrs={"file_path": path})
        progs.append(prog)
    return progs


# ---- delete_var, fake_init and the engine stubs -----------------------------

def misc_program(fluid, **widths):
    """x -> scale (``tmp``) -> delete_var(tmp); fake_init of ``table``
    [vocab, emb] (zeros, only where the scope holds none)."""
    w = dict(SPLIT, **widths)
    L = fluid.layers
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        blk = main.global_block()
        x = L.data(name="x", shape=[4], dtype="float32")
        tmp = L.scale(x, scale=3.0)
        out = L.scale(tmp, scale=1.0)
        blk.append_op(type="delete_var", inputs={"X": [tmp]}, outputs={})
        table = blk.create_var(name="fake_table",
                               shape=[w["vocab"], w["emb"]],
                               dtype="float32", persistable=True)
        blk.append_op(type="fake_init", inputs={}, outputs={"Out": [table]},
                      attrs={"shape": [w["vocab"], w["emb"]]})
    return Model(main, None, None, out, ["x"], {"deleted": tmp.name,
                                               "table": table.name})


def engine_program(fluid, kind):
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        main.global_block().append_op(type=kind, inputs={}, outputs={},
                                      attrs={})
    return main
