"""WMT14 French→English translation (reference:
python/paddle/dataset/wmt14.py — the machine_translation book corpus).

Samples are (src_ids, trg_ids, trg_ids_next): source wrapped in <s>/<e>,
target prefixed with <s>, next-token targets suffixed with <e>
(reference reader_creator:82-113). Ids 0/1/2 are <s>/<e>/<unk>.

Real path: <DATA_HOME>/wmt14/{train,test}.txt with one
"src sentence\ttrg sentence" pair per line plus src.dict/trg.dict (one
token per line, frequency order); otherwise deterministic synthetic pairs.
"""
import os

import numpy as np

from . import common

__all__ = ["train", "test", "START", "END", "UNK", "UNK_IDX"]

START, END, UNK = "<s>", "<e>", "<unk>"
START_IDX, END_IDX, UNK_IDX = 0, 1, 2


def _root():
    return common.cache_path("wmt14")


def _load_dict(path, dict_size):
    d = {START: START_IDX, END: END_IDX, UNK: UNK_IDX}
    with open(path) as f:
        for line in f:
            tok = line.strip().split()[0] if line.strip() else ""
            if tok and tok not in d and len(d) < dict_size:
                d[tok] = len(d)
    return d


def _dicts(dict_size):
    src_p = os.path.join(_root(), "src.dict")
    trg_p = os.path.join(_root(), "trg.dict")
    if os.path.exists(src_p) and os.path.exists(trg_p):
        return _load_dict(src_p, dict_size), _load_dict(trg_p, dict_size)
    base = {START: START_IDX, END: END_IDX, UNK: UNK_IDX}
    src = dict(base)
    trg = dict(base)
    for i in range(3, dict_size):
        src["<f%d>" % i] = i
        trg["<e%d>" % i] = i
    return src, trg


def _pairs(split, n):
    path = os.path.join(_root(), "%s.txt" % split)
    if os.path.exists(path):
        def gen():
            with open(path, errors="ignore") as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) == 2:
                        yield parts[0].split(), parts[1].split()
        return gen
    common.synthetic_note("wmt14")
    rng = common.rng_for("wmt14", split)

    def gen():
        for _ in range(n):
            ln = rng.randint(4, 16)
            src = ["<f%d>" % t for t in rng.randint(3, 30, ln)]
            trg = ["<e%d>" % t for t in rng.randint(3, 30, ln)]
            yield src, trg
    return gen


def reader_creator(split, dict_size, n=256):
    def reader():
        src_dict, trg_dict = _dicts(dict_size)
        for src_words, trg_words in _pairs(split, n)():
            src_ids = [src_dict.get(w, UNK_IDX)
                       for w in [START] + src_words + [END]]
            trg_ids = [trg_dict.get(w, UNK_IDX) for w in trg_words]
            trg_ids_next = trg_ids + [trg_dict[END]]
            trg_ids = [trg_dict[START]] + trg_ids
            arr = lambda x: np.asarray(x, "int64")
            yield arr(src_ids), arr(trg_ids), arr(trg_ids_next)
    return reader


def train(dict_size):
    return reader_creator("train", dict_size)


def test(dict_size):
    return reader_creator("test", dict_size)
