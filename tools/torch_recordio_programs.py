"""The record-file programs and data, built on whichever ``fluid`` module
the caller passes: the port's (``paddle_tpu_torch.fluid``) or the JAX
package's (``paddle_tpu.fluid``). The same code gives the same program on
both, op for op, and the same files, byte for byte; the package's own
``reader.recordio``, ``dataset`` and ``models`` modules are used.

    import paddle_tpu_torch.fluid as fluid
    tool = <this file, loaded by path>
    tool.write_samples(fluid, path, tool.image_samples(fluid, **widths))
    m = tool.recordio_resnet(fluid, path, **tool.RESNET_NARROW)
    exe = fluid.Executor(fluid.CPUPlace()); exe.run(m.startup)
    exe.run(m.main, fetch_list=[m.loss])       # reads the next batch

Programs return ``Model(main, startup, loss, out, feeds, extra)``.

- ``reader_program``: tests/test_graph_readers.py's chain over one record
  file: ``create_recordio_file_reader`` -> (``create_multi_pass_reader``)
  -> ``create_batch_reader`` -> (``create_double_buffer_reader``) ->
  ``read`` into x [batch, 3] and y [batch, 1], and the sum of x;
  ``counting_samples`` are its samples (sample i all i).
- ``open_files_program``: ``open_files`` over record files, then batch and
  read; ``layer=True`` appends it with ``layers.open_files`` (the attr
  ``filenames``, which no handler reads), else by hand with the attr
  ``file_names`` that the handlers read.
- ``recordio_resnet``: bench.py's ResNet-50 leg (the package's
  ``models/resnet.py``, 224, 1,000 classes, Momentum(0.01, 0.9), f32) fed
  by ``create_recordio_file_reader`` -> ``create_batch_reader(batch)`` ->
  ``create_double_buffer_reader`` -> ``read`` into ``img`` and ``label``;
  with ``reader=False`` the same model fed as numpy. ``image_samples``:
  the ``dataset.flowers.train()`` samples (``dataset.cifar.train10()`` at
  the narrow widths), each label as a [1] int64 array, the shape the
  model's ``label`` takes.
- ``ctr_programs``: bench.py's DeepFM leg (the package's
  ``models/deepfm.py``: 26 fields, vocab 100,000, embed 16, MLP 128-64,
  sparse tables, Adam(1e-3)) for ``AsyncExecutor``; ``ctr_samples`` are
  ``samples`` seeded (feat_ids [26] int64, label [1] float32) samples, ids
  uniform over the table (so they repeat within a batch of 4,096), and
  ``write_ctr_files`` splits them over ``files`` record files.
- ``sample_digest`` / ``dataset_digest``: a sha256 of a sample or of a
  dataset stream's first samples;
  ``DATASET_STREAMS`` names each dataset module's train stream (conll05's
  test stream, its only one; ``image``: a transform of a seeded image) and
  ``DATASET_DIGESTS`` pins their digests over ``DIGEST_SAMPLES`` samples.

``*_NARROW`` hold the CPU tests' widths.
"""
import collections
import hashlib
import importlib
import itertools

import numpy as np

Model = collections.namedtuple("Model", "main startup loss out feeds extra")


def package(fluid, name):
    """The module ``name`` of the package that ``fluid`` belongs to."""
    return importlib.import_module(fluid.__name__.split(".")[0] + "." + name)


def _reader_types(fluid):
    return package(fluid, "fluid.core_types").VarType


def write_samples(fluid, path, samples, **kwargs):
    """The package's convert_reader_to_recordio_file over a list of
    samples; returns the record count."""
    rio = package(fluid, "reader.recordio")
    return rio.convert_reader_to_recordio_file(path, lambda: iter(samples),
                                               **kwargs)


# ---- the graph readers over a record file ----------------------------------

def counting_samples(n):
    """tests/test_graph_readers.py's samples: sample i is ([i, i, i] f32,
    [i] int64)."""
    return [[np.full((3,), i, np.float32), np.array([i], np.int64)]
            for i in range(n)]


def _chain(fluid, blk, first, attrs, decorators):
    """A reader chain: ``first`` (an op type and its attrs), then each
    (op type, attrs) of ``decorators`` over the one before; returns the
    last reader variable."""
    VarType = _reader_types(fluid)
    r = blk.create_var(name="r0", type=VarType.READER, persistable=True)
    blk.append_op(type=first, inputs={}, outputs={"Out": [r]}, attrs=attrs)
    for k, (op_type, op_attrs) in enumerate(decorators):
        under = r
        r = blk.create_var(name="r%d" % (k + 1), type=VarType.READER,
                           persistable=True)
        blk.append_op(type=op_type, inputs={"UnderlyingReader": [under]},
                      outputs={"Out": [r]}, attrs=op_attrs)
    return r


def _read_xy(fluid, blk, r, batch):
    x = blk.create_var(name="xv", shape=(batch, 3), dtype="float32")
    y = blk.create_var(name="yv", shape=(batch, 1), dtype="int64")
    blk.append_op(type="read", inputs={"Reader": [r]},
                  outputs={"Out": [x, y]}, attrs={})
    return x, y, fluid.layers.reduce_sum(x)


def reader_program(fluid, path, batch=2, passes=None, double_buffer=False):
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        decorators = []
        if passes:
            decorators.append(("create_multi_pass_reader",
                               {"pass_num": passes}))
        decorators.append(("create_batch_reader", {"batch_size": batch}))
        if double_buffer:
            decorators.append(("create_double_buffer_reader", {}))
        blk = main.global_block()
        r = _chain(fluid, blk, "create_recordio_file_reader",
                   {"filename": path}, decorators)
        x, y, s = _read_xy(fluid, blk, r, batch)
    return Model(main, None, s, y, [], {"x": x.name})


def open_files_program(fluid, paths, batch=2, layer=False):
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        blk = main.global_block()
        if layer:
            under = fluid.layers.open_files(
                list(paths), shapes=[[-1, 3], [-1, 1]], lod_levels=[0, 0],
                dtypes=["float32", "int64"])
            VarType = _reader_types(fluid)
            r = blk.create_var(name="r1", type=VarType.READER,
                               persistable=True)
            blk.append_op(type="create_batch_reader",
                          inputs={"UnderlyingReader": [under]},
                          outputs={"Out": [r]}, attrs={"batch_size": batch})
        else:
            r = _chain(fluid, blk, "open_files",
                       {"file_names": list(paths), "pass_num": 1},
                       [("create_batch_reader", {"batch_size": batch})])
        x, y, s = _read_xy(fluid, blk, r, batch)
    return Model(main, None, s, y, [], {"x": x.name})


# ---- ResNet-50 from a record file -------------------------------------------

RESNET = dict(dataset="flowers", depth=50, image=[3, 224, 224], classes=1000,
              batch=64, samples=256)
RESNET_NARROW = dict(dataset="cifar10", depth=8, image=[3, 32, 32],
                     classes=10, batch=2, samples=8)


def image_samples(fluid, **widths):
    """The first ``samples`` train samples of the image dataset as (image,
    [label] int64): flowers' 3x224x224 images (all 256 of its synthetic
    stream), cifar's 3x32x32 at the narrow widths."""
    w = dict(RESNET, **widths)
    ds = package(fluid, "dataset")
    stream = ds.flowers.train() if w["dataset"] == "flowers" \
        else ds.cifar.train10()
    return [(img, np.array([label], np.int64)) for img, label in
            itertools.islice(stream(), w["samples"])]


def recordio_resnet(fluid, path, seed=140, reader=True, **widths):
    """ResNet fed from the record file ``path`` (reader=True) or as numpy
    feeds of ``img`` and ``label`` (reader=False); the same parameters
    either way."""
    w = dict(RESNET, **widths)
    R = package(fluid, "models.resnet")
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        feeds = []
        if reader:
            blk = main.global_block()
            r = _chain(fluid, blk, "create_recordio_file_reader",
                       {"filename": path},
                       [("create_batch_reader", {"batch_size": w["batch"]}),
                        ("create_double_buffer_reader", {})])
            img = blk.create_var(name="img", shape=[-1] + list(w["image"]),
                                 dtype="float32")
            label = blk.create_var(name="label", shape=[-1, 1],
                                   dtype="int64")
            blk.append_op(type="read", inputs={"Reader": [r]},
                          outputs={"Out": [img, label]}, attrs={})
        else:
            feeds = ["img", "label"]
        _, loss, acc = R.build(dataset=w["dataset"], depth=w["depth"],
                               class_dim=w["classes"])
        fluid.optimizer.Momentum(learning_rate=0.01,
                                 momentum=0.9).minimize(loss)
    return Model(main, startup, loss, acc, feeds, {"widths": w})


def image_feed(samples):
    """A batch of image_samples as the numpy feed of recordio_resnet's
    twin."""
    return {"img": np.stack([s[0] for s in samples]),
            "label": np.stack([s[1] for s in samples])}


# ---- DeepFM through AsyncExecutor ------------------------------------------

CTR = dict(num_fields=26, vocab_size=100000, embed_dim=16, batch=4096,
           samples=32768, files=4)
CTR_NARROW = dict(num_fields=3, vocab_size=50, embed_dim=4, batch=8,
                  samples=40, files=4)


def ctr_programs(fluid, seed=141, **widths):
    w = dict(CTR, **widths)
    D = package(fluid, "models.deepfm")
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        feeds, loss, auc = D.build(num_fields=w["num_fields"],
                                   vocab_size=w["vocab_size"],
                                   embed_dim=w["embed_dim"])
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return Model(main, startup, loss, auc, feeds, {"widths": w})


def ctr_samples(seed, **widths):
    """``samples`` (feat_ids [num_fields] int64, label [1] float32)."""
    w = dict(CTR, **widths)
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, w["vocab_size"],
                      (w["samples"], w["num_fields"])).astype(np.int64)
    labels = rng.randint(0, 2, (w["samples"], 1)).astype(np.float32)
    return [(ids[i], labels[i]) for i in range(w["samples"])]


def write_ctr_files(fluid, prefix, rows, **widths):
    """The samples ``rows`` split over ``files`` record files (the
    package's convert_reader_to_recordio_files); returns the paths."""
    w = dict(CTR, **widths)
    rio = package(fluid, "reader.recordio")
    per_file = -(-len(rows) // w["files"])
    return rio.convert_reader_to_recordio_files(prefix, per_file,
                                                lambda: iter(rows))


def ctr_feeds(rows, batch):
    """The samples ``rows`` in batches of ``batch`` as numpy feeds, in
    order."""
    return [{"feat_ids": np.stack([s[0] for s in rows[i:i + batch]]),
             "label": np.stack([s[1] for s in rows[i:i + batch]])}
            for i in range(0, len(rows), batch)]


# ---- the datasets -----------------------------------------------------------

DIGEST_SAMPLES = 64
DATASET_STREAMS = {
    "mnist": lambda ds: ds.mnist.train(),
    "cifar10": lambda ds: ds.cifar.train10(),
    "cifar100": lambda ds: ds.cifar.train100(),
    "uci_housing": lambda ds: ds.uci_housing.train(),
    "imdb": lambda ds: ds.imdb.train(),
    "imikolov": lambda ds: ds.imikolov.train(),
    "movielens": lambda ds: ds.movielens.train(),
    "wmt14": lambda ds: ds.wmt14.train(30000),
    "wmt16": lambda ds: ds.wmt16.train(),
    "flowers": lambda ds: ds.flowers.train(),
    "conll05": lambda ds: ds.conll05.test(),
    "sentiment": lambda ds: ds.sentiment.train(),
    "mq2007": lambda ds: ds.mq2007.train(),
    "voc2012": lambda ds: ds.voc2012.train(),
    "image": lambda ds: _image_transforms(ds.image),
}
# dataset_digest of DATASET_STREAMS' first DIGEST_SAMPLES samples with no
# cache present (the synthetic streams), the JAX package's and the port's
DATASET_DIGESTS = {
    "mnist": "1da70b12d0b59ef9350fc1c75f1918e5d5d1ac8338eb803e0c3649113b64ba04",
    "cifar10": "65924091db71c6b19156bf72ffba8c680a1f548de1d0a0db1202fdc6a5bddcee",
    "cifar100": "c337e580efacaa017ad6ca58bf97fd444b094987b413fb2d182dd7db41da175a",
    "uci_housing":
        "57baa4b9daea895572c9c2f623fd7b390ac9380767e979c5a755ef1a1304ca7f",
    "imdb": "67056937a56f2e7b78ff9415a903c706de43e72ddedf478c1a1ca1c0d50d80bc",
    "imikolov":
        "3cf6924fc3d32c5aa248bd0c831d38a120317cfa52bc1c4cc7bc7386b573130e",
    "movielens":
        "dc0be0886b3ea8b4559b0876ed9acea651db7a428a156515acc333f98e939121",
    "wmt14": "83ba17e0db474969206f47542d8152104f4cad72fd690506201c929fb60cb407",
    "wmt16": "962969b45a3d2c2b30758445b212221dfa04535f3c6fba2948c490cb42732c16",
    "flowers":
        "e5f420d8360b451919d223116bdb05c681b8b61a94152ccf17f1cf61d3aa642b",
    "conll05":
        "46c57a36e829034a49f6925748cac3f82b9cfdaf446b0f0cd28310b3091719cc",
    "sentiment":
        "2474d8a64a5d37e7d2c81d7e62a8f52eb943174808a56030c516a02567af5c13",
    "mq2007": "3bd07f947bab77c2904e71f2a47f12d3cf715a75812f33d69197fd9e3c79e36f",
    "voc2012":
        "16edb40bff602fc48ed029d4d4aa8c21395088a3a93936a15d54737a388de65f",
    "image": "5f019b6e18f43b63d5e61027473f2d8fd6aa63240954dd2bd26b85d8f1904634",
}


def _image_transforms(image):
    """A reader of image.py's deterministic transforms of one seeded
    300 x 400 RGB image: resize_short, center_crop, to_chw,
    left_right_flip and simple_transform (not training: its crop is
    random)."""
    im = np.random.RandomState(142).randint(0, 256, (300, 400, 3)) \
        .astype(np.uint8)

    def reader():
        r = image.resize_short(im, 256)
        c = image.center_crop(r, 224)
        yield (r, c, image.to_chw(c), image.left_right_flip(c),
               image.simple_transform(im, 256, 224, is_train=False,
                                      mean=[103.94, 116.78, 123.68]))
    return reader


def _update(h, sample):
    """Each slot's numpy dtype, shape and bytes into the hash ``h``."""
    for slot in (sample if isinstance(sample, (tuple, list)) else [sample]):
        a = np.asarray(slot)
        h.update(("%s%s" % (a.dtype, a.shape)).encode())
        h.update(np.ascontiguousarray(a).tobytes())


def sample_digest(sample):
    """sha256 of one sample."""
    h = hashlib.sha256()
    _update(h, sample)
    return h.hexdigest()


def dataset_digest(reader_creator, n=DIGEST_SAMPLES):
    """sha256 of the first ``n`` samples of a stream, in order."""
    h = hashlib.sha256()
    for sample in itertools.islice(reader_creator(), n):
        _update(h, sample)
    return h.hexdigest()
