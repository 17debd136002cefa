"""IMDB sentiment (reference: python/paddle/dataset/imdb.py — tokenized movie
reviews; ragged int sequences + binary label).

Real path: an aclImdb tree under <DATA_HOME>/imdb/aclImdb/ (the reference
tarball layout: {train,test}/{pos,neg}/*.txt) is tokenized exactly like the
reference (lowercase, punctuation split); otherwise deterministic synthetic
sequences keep tests hermetic."""
import glob
import os
import re
import string

import numpy as np

from . import common

_VOCAB = 5148  # reference's word_dict size ballpark
_TOKEN = re.compile(r"[a-z]+|[%s]" % re.escape(string.punctuation))


def _tokenize(text):
    return _TOKEN.findall(text.lower())


def _acl_root():
    return common.cache_path("imdb", "aclImdb")


def _real_files(split):
    pats = [os.path.join(_acl_root(), split, lab, "*.txt")
            for lab in ("pos", "neg")]
    return sorted(glob.glob(pats[0])), sorted(glob.glob(pats[1]))


_WORD_DICT_CACHE = {}


def word_dict():
    """token -> id, ordered by frequency over train+test (reference
    imdb.py build_dict); memoized — the real corpus is ~100k files.
    Falls back to a fixed synthetic vocabulary."""
    root = _acl_root()
    if root in _WORD_DICT_CACHE:
        return _WORD_DICT_CACHE[root]
    if os.path.isdir(_acl_root()):
        freq = {}
        for split in ("train", "test"):
            for files in _real_files(split):
                for path in files:
                    with open(path, errors="ignore") as f:
                        for tok in _tokenize(f.read()):
                            freq[tok] = freq.get(tok, 0) + 1
        toks = sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))
        d = {tok: i for i, (tok, _) in enumerate(toks)}
        d["<unk>"] = len(d)
        _WORD_DICT_CACHE[root] = d
        return d
    path = common.cache_path("imdb", "word_dict.txt")
    if os.path.exists(path):
        with open(path) as f:
            return {w.strip(): i for i, w in enumerate(f)}
    return {"<w%d>" % i: i for i in range(_VOCAB)}


def _reader(split, n=512, word_idx=None):
    if os.path.isdir(_acl_root()):
        word_idx = word_idx or word_dict()
        unk = word_idx.get("<unk>", len(word_idx))
        pos, neg = _real_files(split)

        def reader():
            for label, files in ((0, pos), (1, neg)):
                for path in files:
                    with open(path, errors="ignore") as f:
                        toks = _tokenize(f.read())
                    yield (np.asarray(
                        [word_idx.get(t, unk) for t in toks],
                        "int64"), label)
        return reader

    common.synthetic_note("imdb")
    rng = common.rng_for("imdb", split)

    def reader():
        for _ in range(n):
            length = rng.randint(8, 64)
            words = rng.randint(0, _VOCAB, (length,)).astype("int64")
            label = int(words.sum() % 2)
            yield words, label
    return reader


def train(word_idx=None):
    return _reader("train", word_idx=word_idx)


def test(word_idx=None):
    return _reader("test", word_idx=word_idx)
