"""Movie-review sentiment polarity (reference:
python/paddle/dataset/sentiment.py — NLTK movie_reviews corpus; samples
are (word-id sequence, label) with label 0=negative, 1=positive).

Real path: <DATA_HOME>/sentiment/{pos,neg}/*.txt review files (the
movie_reviews layout); otherwise deterministic synthetic sequences.
"""
import glob
import os
import re
import string

import numpy as np

from . import common

__all__ = ["train", "test", "get_word_dict"]

_VOCAB = 2000
_TOKEN = re.compile(r"[a-z]+|[%s]" % re.escape(string.punctuation))
NUM_TRAINING_INSTANCES_RATIO = 0.8    # reference: first 80% train


def _root():
    return common.cache_path("sentiment")


def _files():
    neg = sorted(glob.glob(os.path.join(_root(), "neg", "*.txt")))
    pos = sorted(glob.glob(os.path.join(_root(), "pos", "*.txt")))
    return neg, pos


_DICT_CACHE = {}


def get_word_dict():
    """word -> id sorted by corpus frequency (reference get_word_dict)."""
    root = _root()
    if root in _DICT_CACHE:
        return _DICT_CACHE[root]
    neg, pos = _files()
    if neg or pos:
        freq = {}
        for path in neg + pos:
            with open(path, errors="ignore") as f:
                for tok in _TOKEN.findall(f.read().lower()):
                    freq[tok] = freq.get(tok, 0) + 1
        toks = sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))
        d = {t: i for i, (t, _) in enumerate(toks)}
    else:
        d = {"<w%d>" % i: i for i in range(_VOCAB)}
    _DICT_CACHE[root] = d
    return d


def _samples():
    neg, pos = _files()
    if neg or pos:
        d = get_word_dict()
        out = []
        # interleave labels like the reference's shuffled corpus
        for i in range(max(len(neg), len(pos))):
            for label, files in ((0, neg), (1, pos)):
                if i < len(files):
                    with open(files[i], errors="ignore") as f:
                        toks = _TOKEN.findall(f.read().lower())
                    ids = [d[t] for t in toks if t in d]
                    out.append((np.asarray(ids, "int64"), label))
        return out
    common.synthetic_note("sentiment")
    rng = common.rng_for("sentiment", "all")
    out = []
    for _ in range(400):
        n = rng.randint(8, 48)
        ids = rng.randint(0, _VOCAB, (n,)).astype("int64")
        out.append((ids, int(ids.sum() % 2)))
    return out


def _split(is_train):
    data = _samples()
    cut = int(len(data) * NUM_TRAINING_INSTANCES_RATIO)
    part = data[:cut] if is_train else data[cut:]

    def reader():
        for ids, label in part:
            yield ids, label
    return reader


def train():
    return _split(True)


def test():
    return _split(False)
