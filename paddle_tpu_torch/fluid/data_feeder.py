"""DataFeeder: sample lists -> a feed dict of dense batches (the port's
counterpart of ``paddle_tpu/fluid/data_feeder.py``; reference:
python/paddle/fluid/data_feeder.py:342, which builds LoDTensors). A ragged
slot becomes a padded numpy batch and its ``<name>@LEN`` lengths, padded
to the same bucketed length as the JAX package's, so the two packages'
feeds are the same arrays."""
import numpy as np

from .core_types import convert_dtype
from .framework import Variable, default_main_program

__all__ = ["DataFeeder"]


def _bucketed_len(maxlen, buckets):
    """The padded length of a ragged batch whose longest row is ``maxlen``:
    buckets=None -> the next power of two, at least 8; a list -> the
    smallest listed bucket that fits, past the last a multiple of it;
    buckets=False (or []) -> maxlen itself. A bounded set of shapes keeps
    a stream of ragged batches from growing the executor's plan and the
    caching allocator's block sizes without end."""
    if buckets is False or buckets == []:
        return maxlen
    if buckets is None:
        b = 8
        while b < maxlen:
            b <<= 1
        return b
    for b in buckets:
        if maxlen <= b:
            return b
    last = buckets[-1]
    return ((maxlen + last - 1) // last) * last


class _Converter(object):
    def __init__(self, shape, dtype, lod_level, seq_buckets=None):
        self.shape = shape
        self.dtype = dtype
        self.lod_level = lod_level
        self.seq_buckets = seq_buckets
        self.data = []

    def feed(self, item):
        self.data.append(np.asarray(item))

    def done(self):
        if self.lod_level == 0:
            arr = np.stack([np.asarray(d, dtype=self.dtype)
                            for d in self.data])
            # the variable's trailing static dims (a label's [-1, 1])
            want = [d for d in self.shape if d is not None]
            if want and len(arr.shape) < len(want):
                arr = arr.reshape(arr.shape + (1,) * (len(want) -
                                                      len(arr.shape)))
            return arr
        seqs = [np.asarray(d, dtype=self.dtype) for d in self.data]
        maxlen = _bucketed_len(max(s.shape[0] for s in seqs),
                               self.seq_buckets)
        out = np.zeros((len(seqs), maxlen) + seqs[0].shape[1:],
                       dtype=self.dtype)
        lengths = np.zeros((len(seqs),), dtype=np.int64)
        for i, s in enumerate(seqs):
            out[i, :s.shape[0]] = s
            lengths[i] = s.shape[0]
        return out, lengths


def _device_count(place):
    """The cards a feed is split over: 1 for a CPUPlace, the visible CUDA
    cards for a CUDAPlace (or no place)."""
    import torch
    if place is not None and getattr(place, "kind", "cuda") == "cpu":
        return 1
    return torch.cuda.device_count()


class DataFeeder(object):
    def __init__(self, feed_list, place=None, program=None,
                 seq_buckets=None):
        """seq_buckets: the padded lengths of ragged feeds (None: powers of
        two, at least 8; a sorted list: its boundaries; False: the batch's
        longest row)."""
        self.seq_buckets = seq_buckets
        self.feed_dtypes = []
        self.feed_names = []
        self.feed_shapes = []
        self.feed_lod_level = []
        program = program or default_main_program()
        for each_var in feed_list:
            if isinstance(each_var, str):
                each_var = program.global_block().var(each_var)
            if not isinstance(each_var, Variable):
                raise TypeError("feed_list should hold Variables or names")
            self.feed_dtypes.append(convert_dtype(each_var.dtype))
            self.feed_names.append(each_var.name)
            self.feed_lod_level.append(each_var.lod_level)
            self.feed_shapes.append(each_var.shape)
        self.place = place

    def feed(self, iterable):
        converters = [
            _Converter(shape, dtype, lod, self.seq_buckets)
            for shape, dtype, lod in zip(self.feed_shapes, self.feed_dtypes,
                                         self.feed_lod_level)]
        for each_sample in iterable:
            assert len(each_sample) == len(converters), (
                "sample has %d slots, feed_list has %d"
                % (len(each_sample), len(converters)))
            for each_converter, each_slot in zip(converters, each_sample):
                each_converter.feed(each_slot)
        ret = {}
        for name, conv, lod in zip(self.feed_names, converters,
                                   self.feed_lod_level):
            result = conv.done()
            if lod > 0:
                ret[name], ret[name + "@LEN"] = result
            else:
                ret[name] = result
        return ret

    def feed_parallel(self, iterable, num_places=None):
        """One feed of every place's batch, concatenated: the executor
        takes the global batch."""
        batches = [self.feed(chunk) for chunk in iterable]
        merged = {}
        for b in batches:
            for k, v in b.items():
                merged.setdefault(k, []).append(v)
        return {k: np.concatenate(v, axis=0) for k, v in merged.items()}

    def decorate_reader(self, reader, multi_devices=True, num_places=None,
                        drop_last=True):
        """A reader of feed dicts (reference data_feeder.py
        decorate_reader): each batch fed whole; with multi_devices its size
        must divide the place's device count (``num_places`` if given),
        and only a last batch that does not may be dropped."""
        def reader_with_check():
            n = num_places or _device_count(self.place)
            held = None
            for batch in reader():
                feed = self.feed(batch)
                first = next(iter(feed.values()))
                if multi_devices and first.shape[0] % n != 0:
                    if held is not None:
                        raise ValueError(
                            "batch size %d not divisible by %d devices "
                            "mid-stream" % (held.shape[0], n))
                    held = first
                    continue
                if held is not None:
                    raise ValueError(
                        "batch size %d not divisible by %d devices "
                        "mid-stream" % (held.shape[0], n))
                yield feed
            if held is not None and not drop_last:
                raise ValueError(
                    "final batch size %d not divisible by %d devices "
                    "(drop_last=False)" % (held.shape[0], n))
        return reader_with_check
