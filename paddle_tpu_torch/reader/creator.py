"""Reader creators from raw sources (the port's copy of
``paddle_tpu/reader/creator.py``; reference: python/paddle/reader/
creator.py)."""
import numpy as np

__all__ = ["np_array", "text_file", "recordio"]


def np_array(x):
    """Reader yielding the rows of a numpy array (creator.py:23)."""
    if not isinstance(x, np.ndarray):
        raise TypeError("np_array creator needs a numpy array")

    def reader():
        for row in x:
            yield row
    return reader


def text_file(path):
    """Reader yielding the lines of a text file, stripped of their newline
    (creator.py:41)."""
    def reader():
        with open(path) as f:
            for line in f:
                yield line.rstrip("\n")
    return reader


def recordio(paths, buf_size=100):
    """Reader over record files written by fluid.recordio_writer
    (creator.py:57): ``paths`` a list or a comma-separated string; the
    samples as lists of numpy arrays."""
    from .recordio import recordio_reader
    if isinstance(paths, str):
        paths = paths.split(",")
    return recordio_reader(paths)
