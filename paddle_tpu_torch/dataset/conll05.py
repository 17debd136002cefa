"""CoNLL-2005 semantic role labeling (reference:
python/paddle/dataset/conll05.py — the label_semantic_roles book corpus).

Each sample is nine parallel sequences: word ids, five predicate-context
windows (ctx_n2..ctx_p2, each broadcast over the sentence), the predicate
id, a 0/1 predicate mark, and IOB label ids (reference reader_creator:150).

Real path: <DATA_HOME>/conll05st/ holding wordDict.txt / verbDict.txt /
targetDict.txt plus a `test.wsj.txt` corpus with one "words ||| verb |||
tags" sentence per line (a flattened form of the conll05st test split);
otherwise deterministic synthetic sentences keep tests hermetic.
"""
import os

import numpy as np

from . import common

__all__ = ["test", "get_dict", "get_embedding", "word_dict", "verb_dict",
           "label_dict"]

UNK_IDX = 0
_WORDS, _VERBS, _LABELS = 200, 20, 9   # synthetic vocabulary sizes


def _root():
    return common.cache_path("conll05st")


def _load_dict(filename):
    d = {}
    with open(filename) as f:
        for i, line in enumerate(f):
            d[line.strip()] = i
    return d


def _load_label_dict(filename):
    """IOB scheme expansion (reference load_label_dict:48): the dict file
    lists B-*/I-* tags; ids pair B/I per tag, then O."""
    tags = []
    with open(filename) as f:
        for line in f:
            line = line.strip()
            if line.startswith(("B-", "I-")) and line[2:] not in tags:
                tags.append(line[2:])
    d = {}
    for tag in tags:
        d["B-" + tag] = len(d)
        d["I-" + tag] = len(d)
    d["O"] = len(d)
    return d


def word_dict():
    path = os.path.join(_root(), "wordDict.txt")
    if os.path.exists(path):
        return _load_dict(path)
    return {"<w%d>" % i: i for i in range(_WORDS)}


def verb_dict():
    path = os.path.join(_root(), "verbDict.txt")
    if os.path.exists(path):
        return _load_dict(path)
    return {"<v%d>" % i: i for i in range(_VERBS)}


def label_dict():
    path = os.path.join(_root(), "targetDict.txt")
    if os.path.exists(path):
        return _load_label_dict(path)
    d = {}
    for t in range((_LABELS - 1) // 2):
        d["B-A%d" % t] = len(d)
        d["I-A%d" % t] = len(d)
    d["O"] = len(d)
    return d


def get_dict():
    """(word_dict, verb_dict, label_dict) — reference get_dict."""
    return word_dict(), verb_dict(), label_dict()


def get_embedding():
    """Pretrained embedding matrix for the word dict (reference downloads
    `emb`; here the cached file or a deterministic random table)."""
    path = os.path.join(_root(), "emb.npy")
    if os.path.exists(path):
        return np.load(path)
    rng = common.rng_for("conll05", "emb")
    return rng.normal(0, 0.1, (len(word_dict()), 32)).astype("float32")


def _corpus():
    """Yield (words, verb, tags) sentences."""
    path = os.path.join(_root(), "test.wsj.txt")
    if os.path.exists(path):
        def gen():
            with open(path) as f:
                for line in f:
                    parts = [p.strip() for p in line.split("|||")]
                    if len(parts) != 3:
                        continue
                    words = parts[0].split()
                    tags = parts[2].split()
                    if len(words) == len(tags):
                        yield words, parts[1], tags
        return gen
    common.synthetic_note("conll05")
    rng = common.rng_for("conll05", "test")
    wd, vd, ld = get_dict()
    words_v = list(wd)
    verbs_v = list(vd)
    labels_v = list(ld)

    def gen():
        for _ in range(256):
            n = rng.randint(5, 20)
            words = [words_v[rng.randint(len(words_v))] for _ in range(n)]
            verb = verbs_v[rng.randint(len(verbs_v))]
            tags = [labels_v[rng.randint(len(labels_v))] for _ in range(n)]
            yield words, verb, tags
    return gen


def test():
    """The nine-sequence SRL reader (reference reader_creator:150)."""
    wd, vd, ld = get_dict()

    def reader():
        for words, verb, tags in _corpus()():
            n = len(words)
            lbl = [ld.get(t, ld.get("O", 0)) for t in tags]
            try:
                verb_index = words.index(verb)
            except ValueError:
                verb_index = 0

            def ctx(off, boundary):
                j = verb_index + off
                if 0 <= j < n:
                    return wd.get(words[j], UNK_IDX)
                return wd.get(boundary, UNK_IDX)

            word_idx = [wd.get(w, UNK_IDX) for w in words]
            ctxs = [[ctx(-2, "bos")] * n, [ctx(-1, "bos")] * n,
                    [ctx(0, "bos")] * n, [ctx(1, "eos")] * n,
                    [ctx(2, "eos")] * n]
            pred_idx = [vd.get(verb, UNK_IDX)] * n
            mark = [1 if i == verb_index else 0 for i in range(n)]
            arr = lambda x: np.asarray(x, "int64")
            yield (arr(word_idx), arr(ctxs[0]), arr(ctxs[1]), arr(ctxs[2]),
                   arr(ctxs[3]), arr(ctxs[4]), arr(pred_idx), arr(mark),
                   arr(lbl))
    return reader
