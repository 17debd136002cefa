"""Data and reader layers (the port's counterpart of
``paddle_tpu/fluid/layers/io.py``).

- ``data`` declares a feed variable. A ragged (lod_level > 0) input is a
  padded [B, T, ...] batch fed with its lengths: ``data`` also declares
  the int64 feed ``<name>@LEN`` [-1] and names it in the variable's
  ``seq_length_var``, which the sequence layers read. ``load`` emits a
  load host op (run by fluid/io.py's handler).
- ``PyReader`` (``fluid.io.PyReader``): a host thread fills a queue of
  numpy batches from a Python generator; iterating it yields feed dicts,
  which ``Executor.run`` copies to the card (from pageable memory, one
  copy a variable). ``py_reader`` / ``create_py_reader_by_data`` make one
  over fresh or given data variables; ``double_buffer`` passes it
  through, as in the JAX package; ``read_file`` gives a PyReader's data
  variables (a graph reader's variable itself: no layer appends a ``read``
  op, as in the JAX package).
- ``shuffle``, ``batch`` and ``random_data_generator`` append the graph
  reader ops that fluid/host_ops.py runs. ``random_data_generator``
  writes the attr ``shapes``, which its handler does not read (it reads
  ``shape_concat`` and ``ranks``), as in the JAX package (ROADMAP Queue
  3).
- ``Preprocessor`` records its ops in the main block between the reader's
  variables and their consumers.
- ``open_files`` appends the graph reader op over record files. It writes
  the attr ``filenames``, which the handler does not read (it reads
  ``file_names``), as in the JAX package (ROADMAP Queue 3): the layer's
  reader reads no file.
"""
import queue as _queue
import threading

import numpy as np

from ..core_types import VarType, convert_dtype
from ..layer_helper import LayerHelper

__all__ = ["data", "py_reader", "double_buffer", "read_file",
           "open_files", "shuffle", "batch", "random_data_generator",
           "load", "Preprocessor",
           "create_py_reader_by_data"]


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         type=VarType.LOD_TENSOR, stop_gradient=True):
    helper = LayerHelper("data")
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    var = helper.create_global_variable(
        name=name, shape=shape, dtype=convert_dtype(dtype),
        type=type, stop_gradient=stop_gradient, lod_level=lod_level,
        is_data=True)
    if lod_level and lod_level > 0:
        length = helper.create_global_variable(
            name=name + "@LEN", shape=[-1], dtype="int64",
            stop_gradient=True, is_data=True)
        var.seq_length_var = length.name
    return var


class PyReader(object):
    """A host-side prefetch queue in place of the reference's
    LoDTensorBlockingQueue + create_py_reader op (reference:
    operators/reader/lod_tensor_blocking_queue.h:31). A thread fills the
    queue (``capacity`` batches) from the decorated generator; ``next()``
    gives the next batch as a feed dict and raises StopIteration at the
    end; iterating starts the thread."""

    _registry = {}     # queue name -> PyReader (create_py_reader binding)

    def __init__(self, feed_list=None, capacity=64, use_double_buffer=True,
                 iterable=False, name=None):
        self._feed_list = feed_list or []
        self._capacity = capacity
        self._queue = _queue.Queue(maxsize=capacity)
        self._thread = None
        self._tensor_provider = None
        self._exited = True
        if name:
            PyReader._registry[name] = self

    def decorate_paddle_reader(self, reader, places=None):
        """A reader of sample lists (paddle.batch's): each batch's slots
        stacked into arrays."""
        def provider():
            for sample_list in reader():
                slots = list(zip(*sample_list)) if isinstance(
                    sample_list, (list, tuple)) and sample_list and isinstance(
                        sample_list[0], (list, tuple)) else sample_list
                yield [np.asarray(s) for s in slots]
        self._tensor_provider = provider

    def decorate_tensor_provider(self, reader, places=None):
        """A generator of lists of arrays, one a feed variable."""
        self._tensor_provider = reader

    decorate_batch_generator = decorate_tensor_provider
    decorate_sample_list_generator = decorate_paddle_reader

    def decorate_sample_generator(self, sample_generator, batch_size,
                                  drop_last=True, places=None):
        """Batch single samples from a generator (reference io.py PyReader
        .decorate_sample_generator)."""
        def provider():
            buf = []
            for sample in sample_generator():
                buf.append(sample)
                if len(buf) == batch_size:
                    yield [np.stack(s) for s in zip(*buf)]
                    buf = []
            if buf and not drop_last:
                yield [np.stack(s) for s in zip(*buf)]
        self._tensor_provider = provider

    def start(self):
        self._exited = False

        def fill():
            try:
                for batch in self._tensor_provider():
                    if self._exited:
                        return
                    self._queue.put(batch)
            finally:
                self._queue.put(None)

        self._thread = threading.Thread(target=fill, daemon=True)
        self._thread.start()

    def reset(self):
        self._exited = True
        self._queue = _queue.Queue(maxsize=self._capacity)

    def next(self):
        batch = self._queue.get()
        if batch is None:
            self.reset()
            raise StopIteration()
        return {v.name: b for v, b in zip(self._feed_list, batch)}

    def __iter__(self):
        self.start()
        while True:
            try:
                yield self.next()
            except StopIteration:
                return


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    """A PyReader bound to fresh data variables, one a slot."""
    from .. import unique_name
    feed_list = []
    for shape, dtype in zip(shapes, dtypes):
        feed_list.append(data(
            name=unique_name.generate((name or "py_reader") + "_slot"),
            shape=list(shape)[1:], dtype=dtype, append_batch_size=True))
    reader = PyReader(feed_list, capacity, use_double_buffer)
    reader.feed_list = feed_list
    return reader


def create_py_reader_by_data(capacity, feed_list, name=None,
                             use_double_buffer=True):
    return PyReader(feed_list, capacity, use_double_buffer)


def double_buffer(reader, place=None, name=None):
    return reader


def read_file(reader):
    if isinstance(reader, PyReader):
        return reader.feed_list
    return reader


def _reader_var(name_hint):
    from ..framework import default_main_program
    from .. import unique_name
    blk = default_main_program().global_block()
    return blk.create_var(name=unique_name.generate(name_hint),
                          type=VarType.READER, persistable=True)


def open_files(filenames, shapes=None, lod_levels=None, dtypes=None,
               thread_num=None, buffer_size=None, pass_num=1, is_test=None):
    """Graph-side reader over record files (reference: layers/io.py
    open_files -> operators/reader/open_files_op.cc); a reader variable
    for read_file(). The op carries the attr ``filenames``, as the JAX
    layer writes it, where the open_files handler of both packages reads
    ``file_names`` (ROADMAP Queue 3)."""
    from ..framework import default_main_program
    out = _reader_var("open_files_reader")
    default_main_program().global_block().append_op(
        type="open_files", inputs={}, outputs={"Out": [out]},
        attrs={"filenames": list(filenames), "pass_num": pass_num})
    return out


def _decorator(op_type, hint, reader, attrs):
    from ..framework import default_main_program
    out = _reader_var(hint)
    default_main_program().global_block().append_op(
        type=op_type, inputs={"UnderlyingReader": [reader]},
        outputs={"Out": [out]}, attrs=attrs)
    return out


def shuffle(reader, buffer_size):
    """Shuffle decorator reader op (reference create_shuffle_reader)."""
    return _decorator("create_shuffle_reader", "shuffle_reader", reader,
                      {"buffer_size": buffer_size})


def batch(reader, batch_size):
    """Batch decorator reader op (reference create_batch_reader)."""
    return _decorator("create_batch_reader", "batch_reader", reader,
                      {"batch_size": batch_size})


def random_data_generator(low, high, shapes, lod_levels, for_parallel=True):
    """Uniform random data reader (reference
    create_random_data_generator_op.cc)."""
    from ..framework import default_main_program
    out = _reader_var("random_data_reader")
    default_main_program().global_block().append_op(
        type="create_random_data_generator", inputs={},
        outputs={"Out": [out]},
        attrs={"low": float(low), "high": float(high),
               "shapes": [list(s) for s in shapes]})
    return out


def load(out, file_path, load_as_fp16=None):
    """Emit a load op filling `out` from file_path (reference load_op.cc)."""
    from ..framework import default_main_program
    default_main_program().global_block().append_op(
        type="load", inputs={}, outputs={"Out": [out]},
        attrs={"file_path": file_path,
               "load_as_fp16": bool(load_as_fp16)})
    return out


class Preprocessor(object):
    """Reader preprocessing (reference layers/io.py Preprocessor, where a
    sub-block rewrites the reader's tuples): the ops built inside
    ``block()`` are recorded in the MAIN block between ``inputs()`` (the
    reader's variables) and their consumers, so they run in the model's
    step."""

    def __init__(self, reader, name=None):
        self.underlying = reader
        self._inputs = None
        self._outputs = None
        self._in_block = False

    class _Guard(object):
        def __init__(self, p):
            self.p = p

        def __enter__(self):
            self.p._in_block = True
            return self.p

        def __exit__(self, *a):
            self.p._in_block = False
            if self.p._outputs is None:
                raise RuntimeError("Preprocessor.block must call outputs()")
            return False

    def block(self):
        return Preprocessor._Guard(self)

    def inputs(self):
        if not self._in_block:
            raise RuntimeError("inputs() only inside Preprocessor.block()")
        if self._inputs is None:
            self._inputs = read_file(self.underlying)
            if not isinstance(self._inputs, (list, tuple)):
                self._inputs = [self._inputs]
        return list(self._inputs)

    def outputs(self, *outs):
        if not self._in_block:
            raise RuntimeError("outputs() only inside Preprocessor.block()")
        self._outputs = list(outs)

    def __call__(self):
        if self._outputs is None:
            raise RuntimeError("run Preprocessor.block() first")
        return list(self._outputs)
