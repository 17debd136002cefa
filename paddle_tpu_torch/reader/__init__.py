"""Reader pipeline: composable Python data-reader decorators (the port's
copy of ``paddle_tpu/reader/``; reference: python/paddle/reader/
decorator.py:36-360 and python/paddle/batch.py). A *reader creator* is a
zero-argument callable returning an iterable of samples.
"""
from .decorator import (cache, map_readers, shuffle, chain, compose, buffered,
                        firstn, xmap_readers, multiprocess_reader, Fake,
                        PipeReader)
from . import creator

__all__ = ["Fake", "PipeReader", "creator", "cache", "map_readers",
           "shuffle", "chain", "compose", "buffered", "firstn",
           "xmap_readers", "multiprocess_reader", "batch"]


def batch(reader, batch_size, drop_last=False):
    """Group samples into lists of ``batch_size`` (reference:
    python/paddle/batch.py)."""
    def batch_reader():
        b = []
        for sample in reader():
            b.append(sample)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    return batch_reader
