"""WMT16 en-de translation pairs (reference: python/paddle/dataset/wmt16.py —
(src_ids, trg_ids, trg_ids_next) tuples with <s>/<e>/<unk>)."""
import numpy as np

from . import common


def _reader(split, src_dict_size, trg_dict_size, n=1024):
    common.synthetic_note("wmt16")
    rng = common.rng_for("wmt16", split)
    bos, eos = 0, 1

    def reader():
        for _ in range(n):
            slen = rng.randint(4, 30)
            tlen = rng.randint(4, 30)
            src = rng.randint(3, src_dict_size, (slen,)).astype("int64")
            trg = rng.randint(3, trg_dict_size, (tlen,)).astype("int64")
            trg_in = np.concatenate([[bos], trg])
            trg_next = np.concatenate([trg, [eos]])
            yield src.tolist(), trg_in.tolist(), trg_next.tolist()
    return reader


def train(src_dict_size=10000, trg_dict_size=10000, src_lang="en"):
    return _reader("train", src_dict_size, trg_dict_size)


def test(src_dict_size=10000, trg_dict_size=10000, src_lang="en"):
    return _reader("test", src_dict_size, trg_dict_size, n=128)


def get_dict(lang, dict_size, reverse=False):
    d = {"<s>": 0, "<e>": 1, "<unk>": 2}
    for i in range(3, dict_size):
        d["<%s%d>" % (lang, i)] = i
    if reverse:
        return {v: k for k, v in d.items()}
    return d
