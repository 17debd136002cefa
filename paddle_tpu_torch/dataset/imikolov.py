"""PTB language-model n-grams (reference: python/paddle/dataset/imikolov.py)."""
import numpy as np

from . import common

_VOCAB = 2074


def build_dict(min_word_freq=50):
    return {"<w%d>" % i: i for i in range(_VOCAB)}


def _reader(split, n, window):
    common.synthetic_note("imikolov")
    rng = common.rng_for("imikolov", split)

    def reader():
        for _ in range(n):
            yield tuple(int(v) for v in rng.randint(0, _VOCAB, (window,)))
    return reader


def train(word_idx=None, n=5):
    return _reader("train", 2048, n)


def test(word_idx=None, n=5):
    return _reader("test", 256, n)
