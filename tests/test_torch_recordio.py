"""Record files in the port (``paddle_tpu_torch.native``,
``paddle_tpu_torch.reader.recordio``, the graph reader ops over them)
against the JAX package's on the CPU; tools/torch_recordio_programs.py
builds the programs on either package.

- Files: for the same samples and chunk sizes the two writers' files are
  byte for byte equal, and each package reads the other's. The cases of
  tests/test_native_io.py run on both packages' readers: a flipped payload
  byte raises; the Paddle reference's wire format reads uncompressed and
  snappy-framed (literal and copy elements, stored frames, padding); gzip,
  a bad chunk crc and a bad frame crc raise; the threaded feeder gives
  every record of its files.
- The feeder's difference from the reference that both packages share
  (ROADMAP Queue 3): it skips a file it cannot open and the rest of a file
  after a corrupt chunk without an error, where RecordScanner raises.
- The host library: built at first use under build/paddle_tpu_torch/,
  never beside the sources; a feeder closed half read joins its threads;
  a call blocked in the library lets Python threads run.
- ``encode_sample`` / ``decode_sample`` over all 8 dtypes with 0-d and
  empty slots, the JAX package's bytes; torch tensors encode as their
  values; bfloat16 raises.
- The graph reader programs of tests/test_graph_readers.py (batch, EOF
  and the next pass, multi-pass, double buffer) fetch what the JAX
  executor fetches; ``open_files`` with ``file_names`` reads every record
  in both packages; ResNet fed by the record file reader takes the same
  step as its numpy-fed twin, bit for bit, and the JAX package's within
  1e-5 from the same parameters.
"""
import importlib.util
import os
import struct
import threading
import zlib

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu.native as jnative
import paddle_tpu.reader.recordio as jrio
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.native as tnative
import paddle_tpu_torch.reader.recordio as trio
from paddle_tpu_torch.fluid.executor import as_numpy
from paddle_tpu_torch.fluid.interop import tensor_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
spec = importlib.util.spec_from_file_location(
    "torch_recordio_programs", os.path.join(ROOT, "tools",
                                            "torch_recordio_programs.py"))
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)

NATIVE = {"port": tnative, "jax": jnative}
RIO = {"port": trio, "jax": jrio}
TOL = 1e-5


def _cpu(fluid):
    return fluid.Executor(fluid.CPUPlace())


def _mixed_samples(n, seed=0):
    rng = np.random.RandomState(seed)
    return [[rng.rand(rng.randint(1, 5), 3).astype(np.float32),
             np.array([i], np.int64), np.array(i % 2 == 0),
             rng.randint(0, 255, (rng.randint(0, 40),)).astype(np.uint8)]
            for i in range(n)]


def _same_slots(got, want):
    """Decoded slots against the slots written: a 0-d slot comes back as
    shape [1] (see test_a_0d_slot_comes_back_as_shape_1_in_both_packages)."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.atleast_1d(np.asarray(b))
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---- files, byte for byte ---------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 7, 1000])
def test_files_written_by_either_package_are_equal_and_read_by_the_other(
        chunk, tmp_path):
    samples = _mixed_samples(60)
    paths = {}
    for k, rio in RIO.items():
        paths[k] = str(tmp_path / ("%s.rec" % k))
        assert rio.convert_reader_to_recordio_file(
            paths[k], lambda: iter(samples),
            max_records_per_chunk=chunk) == len(samples)
    with open(paths["port"], "rb") as f, open(paths["jax"], "rb") as g:
        assert f.read() == g.read()
    for reader, writer in (("port", "jax"), ("jax", "port")):
        got = list(RIO[reader].recordio_reader(paths[writer])())
        assert len(got) == len(samples)
        for g, w in zip(got, samples):
            _same_slots(g, w)


def test_split_files_are_equal_and_read_whole(tmp_path):
    samples = _mixed_samples(25)
    written = {}
    for k, rio in RIO.items():
        written[k] = rio.convert_reader_to_recordio_files(
            str(tmp_path / k), 7, lambda: iter(samples))
        assert [os.path.basename(p) for p in written[k]] == \
            ["%s-%05d" % (k, i) for i in range(4)]
    for p, q in zip(written["port"], written["jax"]):
        with open(p, "rb") as f, open(q, "rb") as g:
            assert f.read() == g.read()
    for k, rio in RIO.items():
        got = list(rio.recordio_reader(written[k], num_threads=3)())
        key = lambda s: int(s[1][0])
        assert sorted(int(s[1][0]) for s in got) == list(range(25))
        for g in sorted(got, key=key):
            _same_slots(g, samples[key(g)])


def test_feeder_files_are_equal_in_both_packages(tmp_path):
    """convert_reader_to_recordio_file with a DataFeeder and feed_order:
    each sample through the package's feeder, the slots in feed_order."""
    samples = [(np.arange(4, dtype=np.float32) + i, i % 3) for i in range(9)]
    blobs = []
    for fluid, rio in ((tfluid, trio), (jfluid, jrio)):
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        feeder = fluid.DataFeeder(feed_list=[x, y], program=main)
        path = str(tmp_path / fluid.__name__)
        rio.convert_reader_to_recordio_file(
            path, lambda: iter(samples), feeder=feeder, feed_order=["y", "x"])
        with open(path, "rb") as f:
            blobs.append(f.read())
        first = next(iter(rio.recordio_reader(path)()))
        assert first[0].shape == (1, 1) and first[1].shape == (1, 4)
    assert blobs[0] == blobs[1]


# ---- tests/test_native_io.py's cases, on both packages ---------------------

@pytest.mark.parametrize("pkg", sorted(NATIVE))
def test_records_round_trip(pkg, tmp_path):
    N = NATIVE[pkg]
    path = str(tmp_path / "data.rec")
    records = [b"hello", b"x" * 5000, b"", b"world"]
    with N.RecordWriter(path, max_records_per_chunk=2) as w:
        for r in records:
            w.write(r)
    with N.RecordScanner(path) as s:
        assert list(s) == records


@pytest.mark.parametrize("pkg", sorted(NATIVE))
def test_flipped_payload_byte_raises(pkg, tmp_path):
    N = NATIVE[pkg]
    path = str(tmp_path / "data.rec")
    with N.RecordWriter(path) as w:
        w.write(b"a" * 1000)
    blob = bytearray(open(path, "rb").read())
    blob[50] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    with N.RecordScanner(path) as s:
        with pytest.raises(IOError, match="corrupt"):
            list(s)


def _ref_chunk(records, compressor=0, crc=None, framed=None):
    payload = b"".join(struct.pack("<I", len(r)) + r for r in records)
    body = payload if framed is None else framed(payload)
    crc = zlib.crc32(body) & 0xFFFFFFFF if crc is None else crc
    return struct.pack("<IIIII", 0x01020304, len(records), crc, compressor,
                       len(body)) + body


def _crc32c(data):
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
    return crc ^ 0xFFFFFFFF


def _mask(crc):
    return (((crc >> 15) | (crc << 17)) + 0xa282ead8) & 0xFFFFFFFF


def _varint(n):
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if not n:
            return out + bytes([b])
        out += bytes([b | 0x80])


def _frame(kind, data, crc_of):
    body = struct.pack("<I", _mask(_crc32c(crc_of))) + data
    return bytes([kind]) + struct.pack("<I", len(body))[:3] + body


_STREAM_ID = b"\xff\x06\x00\x00sNaPpY"


def _literal_block(data):
    n = len(data)
    tag = bytes([(n - 1) << 2]) if n <= 60 else \
        bytes([61 << 2]) + struct.pack("<H", n - 1)
    return _varint(n) + tag + data


def _snappy_literal(payload):
    return _STREAM_ID + _frame(0x00, _literal_block(payload), payload)


def _snappy_copy(payload):
    """A literal of the first 8 bytes, then one copy of offset 4 that
    overlaps its own output (the payload repeats with period 4 after its
    length prefix)."""
    lit = bytes([(8 - 1) << 2]) + payload[:8]
    copy = bytes([((len(payload) - 8 - 1) << 2) | 2]) + struct.pack("<H", 4)
    return _STREAM_ID + _frame(0x00, _varint(len(payload)) + lit + copy,
                               payload)


def _stored_with_padding(payload):
    pad = b"\xfe" + struct.pack("<I", 3)[:3] + b"\x00\x00\x00"
    return _STREAM_ID + pad + _frame(0x01, payload, payload)


REFERENCE_FILES = {
    "uncompressed": lambda: (
        [b"alpha", b"", b"gamma" * 100, b"\x00\x01\x02"],
        _ref_chunk([b"alpha", b""]) +
        _ref_chunk([b"gamma" * 100, b"\x00\x01\x02"])),
    "snappy_literals": lambda: (
        [b"alpha", b"", b"gamma" * 200, bytes(range(256))],
        _ref_chunk([b"alpha", b""], 1, framed=_snappy_literal) +
        _ref_chunk([b"gamma" * 200, bytes(range(256))], 1,
                   framed=_snappy_literal)),
    "snappy_copy": lambda: (
        [b"abcd" * 10], _ref_chunk([b"abcd" * 10], 1, framed=_snappy_copy)),
    "snappy_stored_and_padding": lambda: (
        [b"plainbytes"],
        _ref_chunk([b"plainbytes"], 1, framed=_stored_with_padding)),
}


@pytest.mark.parametrize("pkg", sorted(NATIVE))
@pytest.mark.parametrize("case", sorted(REFERENCE_FILES))
def test_reference_wire_format_reads(pkg, case, tmp_path):
    records, blob = REFERENCE_FILES[case]()
    path = str(tmp_path / "ref.recordio")
    open(path, "wb").write(blob)
    with NATIVE[pkg].RecordScanner(path) as s:
        assert list(s) == records


def _bad_frame_crc(payload):
    framed = bytearray(_stored_with_padding(payload))
    framed[-len(payload) - 4] ^= 0xFF
    return bytes(framed)


BAD_REFERENCE_FILES = {
    "gzip": (lambda: _ref_chunk([b"hi"], compressor=2), "compressor"),
    "chunk_crc": (lambda: _ref_chunk([b"hi"], crc=0xDEADBEEF), "corrupt"),
    "frame_crc": (lambda: _ref_chunk([b"plainbytes"], 1,
                                     framed=_bad_frame_crc), "corrupt"),
}


@pytest.mark.parametrize("pkg", sorted(NATIVE))
@pytest.mark.parametrize("case", sorted(BAD_REFERENCE_FILES))
def test_reference_wire_format_faults_raise(pkg, case, tmp_path):
    make, match = BAD_REFERENCE_FILES[case]
    path = str(tmp_path / "bad.recordio")
    open(path, "wb").write(make())
    with NATIVE[pkg].RecordScanner(path) as s:
        with pytest.raises(IOError, match=match):
            list(s)


def _sample_files(tmp_path, n_files=3, n=50):
    paths = []
    for fi in range(n_files):
        paths.append(str(tmp_path / ("s%d.rec" % fi)))
        tool.write_samples(tfluid, paths[-1], tool.counting_samples(n))
    return paths


def _three_files(tmp_path, N):
    files, expected = [], set()
    for fi in range(3):
        path = str(tmp_path / ("f%d.rec" % fi))
        with N.RecordWriter(path, max_records_per_chunk=10) as w:
            for r in range(50):
                rec = b"f%d-r%d" % (fi, r)
                w.write(rec)
                expected.add(rec)
        files.append(path)
    return files, expected


@pytest.mark.parametrize("pkg", sorted(NATIVE))
def test_multifile_feeder_gives_every_record(pkg, tmp_path):
    N = NATIVE[pkg]
    files, expected = _three_files(tmp_path, N)
    with N.MultiFileFeeder(files, num_threads=3, queue_capacity=16) as f:
        got = list(f)
    assert len(got) == len(expected) and set(got) == expected


def test_feeder_drops_a_corrupt_files_records_in_both_packages(tmp_path):
    """A corrupt chunk ends its file in the feeder without an error, and a
    missing file is skipped: the records before the chunk come, the rest
    do not. RecordScanner raises on the same file. (ROADMAP Queue 3: the
    reference's reader raises.)"""
    files, _ = _three_files(tmp_path, tnative)
    blob = bytearray(open(files[1], "rb").read())
    # a byte of the second chunk's payload: past the first chunk's 24-byte
    # header, its payload (its length at byte 8) and the second's header
    first = struct.unpack_from("<Q", blob, 8)[0]
    blob[24 + first + 24 + 3] ^= 0xFF
    open(files[1], "wb").write(bytes(blob))
    missing = str(tmp_path / "missing.rec")
    want = {b"f%d-r%d" % (fi, r) for fi in (0, 2) for r in range(50)} | \
        {b"f1-r%d" % r for r in range(10)}
    for N in NATIVE.values():
        with N.MultiFileFeeder(files + [missing], num_threads=2) as f:
            assert set(f) == want
        with N.RecordScanner(files[1]) as s:
            with pytest.raises(IOError, match="corrupt"):
                list(s)
    samples = _sample_files(tmp_path, 2)
    blob = bytearray(open(samples[1], "rb").read())
    blob[-5] ^= 0xFF              # a byte of the file's only chunk
    open(samples[1], "wb").write(bytes(blob))
    for rio in RIO.values():
        got = list(rio.recordio_reader(samples, num_threads=2)())
        assert sorted(int(s[1][0]) for s in got) == list(range(50))


def test_host_library_builds_under_build_not_beside_the_sources():
    path = tnative.library_path()
    tnative.lib()
    assert os.path.exists(path)
    build = os.path.join(ROOT, "build", "paddle_tpu_torch")
    assert os.path.dirname(os.path.dirname(path)) == build
    src = os.path.join(ROOT, "paddle_tpu_torch", "native")
    assert sorted(f for f in os.listdir(src) if f != "__pycache__") == \
        ["__init__.py", "feeder.cc", "recordio.cc"]


def _threads():
    return len(os.listdir("/proc/self/task"))


def test_a_half_read_feeder_closes_and_joins_its_threads(tmp_path):
    files = _sample_files(tmp_path)
    before = _threads()
    f = tnative.MultiFileFeeder(files, num_threads=4, queue_capacity=2)
    it = iter(f)
    next(it)
    assert _threads() == before + 4
    f.close()
    assert _threads() == before
    assert list(it) == []
    # a record reader abandoned mid-file closes its feeder
    reader = trio.recordio_reader(files, num_threads=3, queue_capacity=2)()
    next(reader)
    assert _threads() == before + 3
    reader.close()
    assert _threads() == before


def test_a_blocked_feeder_call_lets_python_threads_run(tmp_path):
    """The feeder's thread opens a FIFO, which blocks until a writer comes;
    the main thread waits in pttfeed_next meanwhile. Only a Python thread
    can write the records into the FIFO, so the read ends only if the
    waiting call released the interpreter lock."""
    src = str(tmp_path / "src.rec")
    with tnative.RecordWriter(src) as w:
        for i in range(5):
            w.write(b"rec%d" % i)
    fifo = str(tmp_path / "fifo")
    os.mkfifo(fifo)
    got = []

    def read():
        with tnative.MultiFileFeeder([fifo], num_threads=1) as f:
            got.extend(f)

    reader = threading.Thread(target=read)
    reader.start()
    with open(fifo, "wb") as out, open(src, "rb") as f:
        out.write(f.read())
    reader.join(timeout=30)
    assert not reader.is_alive()
    assert got == [b"rec%d" % i for i in range(5)]


# ---- encode_sample / decode_sample ------------------------------------------

DTYPES = ["float32", "float64", "int32", "int64", "uint8", "int8", "bool",
          "float16"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_sample_codec_over_each_dtype(dtype):
    rng = np.random.RandomState(1)
    slots = [(rng.rand(3, 4) * 100).astype(dtype),
             np.asarray(rng.rand() * 10).astype(dtype),    # 0-d
             np.zeros((0, 5), dtype),                       # empty
             np.zeros((2, 0, 3), dtype)]
    blob = trio.encode_sample(slots)
    assert blob == jrio.encode_sample(slots)
    for rio in RIO.values():
        out = rio.decode_sample(blob)
        _same_slots(out, slots)
    out = trio.decode_sample(blob)
    assert not out[0].flags.writeable
    t = tensor_from_numpy(out[0])           # a copy, not a shared view
    assert t.data_ptr() != out[0].ctypes.data
    assert trio.encode_sample([torch.from_numpy(s.copy()) for s in slots]) \
        == blob


def test_a_0d_slot_comes_back_as_shape_1_in_both_packages():
    """encode_sample writes a 0-d slot as shape [1]
    (np.ascontiguousarray gives at least one dimension), so the reader
    gives [1] for a scalar label, in both packages (ROADMAP Queue 3)."""
    slots = [np.float32(1.5), np.asarray(7, np.int64), 3]
    blob = trio.encode_sample(slots)
    assert blob == jrio.encode_sample(slots)
    for rio in RIO.values():
        assert [a.shape for a in rio.decode_sample(blob)] == [(1,)] * 3


def test_sample_codec_takes_numbers_and_refuses_bfloat16():
    blob = trio.encode_sample([3, 2.5, [1, 2], True])
    assert blob == jrio.encode_sample([3, 2.5, [1, 2], True])
    out = trio.decode_sample(blob)
    assert [a.dtype.name for a in out] == ["int64", "float64", "int64",
                                           "bool"]
    with pytest.raises(TypeError, match="bfloat16"):
        trio.encode_sample([torch.ones(2, dtype=torch.bfloat16)])
    with pytest.raises(TypeError, match="complex"):
        trio.encode_sample([np.ones(2, np.complex64)])


# ---- the graph readers over record files ------------------------------------

GRAPH_CASES = {
    # (samples, reader_program kwargs, runs before and after the EOF)
    "batch_eof_next_pass": (6, dict(batch=2), 3, 1),
    "multi_pass": (2, dict(batch=2, passes=3), 3, 1),
    "double_buffer_partial_batch_dropped": (
        7, dict(batch=2, double_buffer=True), 3, 2),
}


def _graph_fetches(fluid, path, kwargs, before, after):
    m = tool.reader_program(fluid, path, **kwargs)
    exe, scope = _cpu(fluid), fluid.Scope()
    out = []

    def run():
        x, y = exe.run(m.main, fetch_list=[m.extra["x"], m.out],
                       scope=scope)
        out.append((as_numpy(x), as_numpy(y)))
    for _ in range(before):
        run()
    eof = False
    try:
        run()
    except fluid.EOFException:
        eof = True
    for _ in range(after):
        run()
    return out, eof


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graph_reader_programs_fetch_what_jax_fetches(case, tmp_path):
    n, kwargs, before, after = GRAPH_CASES[case]
    path = str(tmp_path / "d.recordio")
    tool.write_samples(tfluid, path, tool.counting_samples(n))
    got, got_eof = _graph_fetches(tfluid, path, kwargs, before, after)
    want, want_eof = _graph_fetches(jfluid, path, kwargs, before, after)
    assert got_eof and want_eof
    assert len(got) == len(want) == before + after
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype and gy.dtype == wy.dtype
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    if case == "batch_eof_next_pass":
        assert [float(x.sum()) for x, _ in got] == [3.0, 15.0, 27.0, 3.0]


def test_open_files_with_file_names_reads_every_record_in_both_packages(
        tmp_path):
    paths = []
    for k in range(2):
        paths.append(str(tmp_path / ("f%d.rec" % k)))
        tool.write_samples(tfluid, paths[-1],
                           [[np.full((3,), 10 * k + i, np.float32),
                             np.array([10 * k + i], np.int64)]
                            for i in range(4)])
    for fluid in (tfluid, jfluid):
        m = tool.open_files_program(fluid, paths, batch=2)
        exe, scope = _cpu(fluid), fluid.Scope()
        ids = []
        with pytest.raises(fluid.EOFException):
            for _ in range(5):
                y, = exe.run(m.main, fetch_list=[m.out], scope=scope)
                ids.extend(np.asarray(as_numpy(y)).reshape(-1).tolist())
        assert sorted(ids) == [0, 1, 2, 3, 10, 11, 12, 13]


def _jax_state(m):
    scope = jfluid.Scope()
    _cpu(jfluid).run(m.startup, scope=scope)
    return scope, {v.name: np.asarray(scope.get(v.name))
                   for v in m.main.global_block().vars.values()
                   if v.persistable and scope.get(v.name) is not None}


def test_resnet_from_a_record_file_steps_as_numpy_feeds_and_jax(tmp_path):
    w = tool.RESNET_NARROW
    path = str(tmp_path / "images.rec")
    samples = tool.image_samples(tfluid, **w)
    assert tool.write_samples(tfluid, path, samples) == w["samples"]
    jm = tool.recordio_resnet(jfluid, path, **w)
    jscope, state = _jax_state(jm)
    losses = {}
    for name, reader in (("reader", True), ("numpy", False)):
        m = tool.recordio_resnet(tfluid, path, reader=reader, **w)
        exe, scope = _cpu(tfluid), tfluid.Scope()
        exe.run(m.startup, scope=scope)
        tfluid.params_from_numpy(state, scope, "cpu")
        losses[name] = []
        for k in range(2):
            feed = {} if reader else tool.image_feed(
                samples[k * w["batch"]:(k + 1) * w["batch"]])
            loss, = exe.run(m.main, feed=feed, fetch_list=[m.loss],
                            scope=scope)
            losses[name].append(float(loss.reshape(-1)[0]))
    assert losses["reader"] == losses["numpy"]
    want = [float(np.asarray(_cpu(jfluid).run(
        jm.main, fetch_list=[jm.loss], scope=jscope)[0]).reshape(-1)[0])
        for _ in range(2)]
    np.testing.assert_allclose(losses["reader"], want, rtol=TOL)
    # a reordered batch is a different step: the control
    m = tool.recordio_resnet(tfluid, path, reader=False, **w)
    exe, scope = _cpu(tfluid), tfluid.Scope()
    exe.run(m.startup, scope=scope)
    tfluid.params_from_numpy(state, scope, "cpu")
    swapped = [samples[0], samples[w["batch"]]]
    loss, = exe.run(m.main, feed=tool.image_feed(swapped),
                    fetch_list=[m.loss], scope=scope)
    assert float(loss.reshape(-1)[0]) != losses["reader"][0]
