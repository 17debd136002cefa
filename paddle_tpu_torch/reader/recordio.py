"""Samples of numpy arrays in record files (the port's copy of
``paddle_tpu/reader/recordio.py``; reference: fluid/recordio_writer.py's
convert_reader_to_recordio_file and the recordio reader ops).

A record holds one sample's slots: [u32 nslots], then for each slot
[u8 dtype code][u8 ndim][u32 dims...][raw bytes], the JAX package's layout,
so the two packages' files are the same bytes. A slot may be a numpy array,
a number, a list or a torch tensor (copied to the host); bfloat16 has no
dtype code. Decoded slots are read-only numpy views of the record's bytes:
the port's feeds (``DataFeeder``, the graph readers' ``read``) copy them.
"""
import itertools
import struct

import numpy as np
import torch

from ..native import RecordWriter, RecordScanner, MultiFileFeeder

__all__ = ["encode_sample", "decode_sample",
           "convert_reader_to_recordio_file",
           "convert_reader_to_recordio_files", "recordio_reader"]

_DTYPES = ["float32", "float64", "int32", "int64", "uint8", "int8", "bool",
           "float16"]
_DTYPE_CODE = {d: i for i, d in enumerate(_DTYPES)}


def _host_array(slot):
    if isinstance(slot, torch.Tensor):
        if slot.dtype == torch.bfloat16:
            raise TypeError("a bfloat16 slot has no dtype code in the record "
                            "format; cast it to float32 first")
        slot = slot.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(slot))
    if str(a.dtype) not in _DTYPE_CODE:
        raise TypeError("a %s slot has no dtype code in the record format "
                        "(%s)" % (a.dtype, ", ".join(_DTYPES)))
    return a


def encode_sample(slots):
    parts = [struct.pack("<I", len(slots))]
    for s in slots:
        a = _host_array(s)
        parts.append(struct.pack("<BB", _DTYPE_CODE[str(a.dtype)], a.ndim))
        parts.append(struct.pack("<%dI" % a.ndim, *a.shape))
        parts.append(a.tobytes())
    return b"".join(parts)


def decode_sample(data):
    (nslots,) = struct.unpack_from("<I", data, 0)
    off = 4
    slots = []
    for _ in range(nslots):
        code, ndim = struct.unpack_from("<BB", data, off)
        off += 2
        dims = struct.unpack_from("<%dI" % ndim, data, off)
        off += 4 * ndim
        dtype = np.dtype(_DTYPES[code])
        n = int(np.prod(dims)) if ndim else 1
        a = np.frombuffer(data, dtype=dtype, count=n, offset=off).reshape(dims)
        off += n * dtype.itemsize
        slots.append(a)
    return slots


def convert_reader_to_recordio_file(filename, reader_creator, feeder=None,
                                    compressor=None, max_num_records=1000,
                                    feed_order=None,
                                    max_records_per_chunk=None):
    """Write every sample of a reader into one record file; returns the
    record count (reference: fluid/recordio_writer.py). With a feeder, each
    sample goes through ``feeder.feed([sample])`` and its slots are written
    in ``feed_order`` (by default the feed's order)."""
    if max_records_per_chunk is None:
        max_records_per_chunk = max_num_records
    count = 0
    with RecordWriter(filename, max_records_per_chunk) as w:
        for sample in reader_creator():
            if feeder is not None:
                fed = feeder.feed([sample])
                order = feed_order or list(fed)
                sample = [fed[name] for name in order]
            w.write(encode_sample(sample))
            count += 1
    return count


def convert_reader_to_recordio_files(filename, batch_per_file, reader_creator,
                                     feeder=None, compressor=None,
                                     max_num_records=1000, feed_order=None):
    """Split a reader over record files ``<filename>-00000``, ... of
    ``batch_per_file`` samples each (reference recordio_writer.py:36).
    Returns the paths. As in the JAX package, the files are written with
    the default chunking and without the feeder."""
    it = reader_creator()
    paths = []
    idx = 0
    while True:
        chunk = list(itertools.islice(it, batch_per_file))
        if not chunk:
            break
        path = "%s-%05d" % (filename, idx)
        convert_reader_to_recordio_file(path, lambda c=chunk: iter(c))
        paths.append(path)
        idx += 1
    return paths


def recordio_reader(filenames, num_threads=1, queue_capacity=4096):
    """A reader creator over record files: one file with one thread reads
    in order through ``RecordScanner``; otherwise ``num_threads`` native
    threads read the files through ``MultiFileFeeder``, in no fixed order
    across files (and a corrupt file's rest is skipped, see
    MultiFileFeeder)."""
    if isinstance(filenames, str):
        filenames = [filenames]

    def reader():
        if num_threads <= 1 and len(filenames) == 1:
            with RecordScanner(filenames[0]) as s:
                for rec in s:
                    yield decode_sample(rec)
        else:
            with MultiFileFeeder(filenames, num_threads,
                                 queue_capacity) as f:
                for rec in f:
                    yield decode_sample(rec)
    return reader
