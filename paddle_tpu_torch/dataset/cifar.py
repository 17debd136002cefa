"""CIFAR-10/100 (reference: python/paddle/dataset/cifar.py). Local cache:
pickled batch files under <DATA_HOME>/cifar/."""
import os
import pickle

import numpy as np

from . import common


def _load_batches(dirname, prefix):
    data, labels = [], []
    for fn in sorted(os.listdir(dirname)):
        if not fn.startswith(prefix):
            continue
        with open(os.path.join(dirname, fn), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        data.append(np.asarray(d[b"data"]))
        labels.extend(d.get(b"labels", d.get(b"fine_labels")))
    return np.concatenate(data), np.asarray(labels)


def _reader(split, num_classes):
    dirname = common.cache_path(
        "cifar", "cifar-10-batches-py" if num_classes == 10
        else "cifar-100-python")
    prefix = ("data_batch" if split == "train" else "test_batch") \
        if num_classes == 10 else ("train" if split == "train" else "test")
    if os.path.isdir(dirname):
        data, labels = _load_batches(dirname, prefix)
        data = data.astype("float32") / 255.0
    else:
        common.synthetic_note("cifar%d" % num_classes)
        rng = common.rng_for("cifar%d" % num_classes, split)
        n = 1024
        data = rng.rand(n, 3072).astype("float32")
        labels = rng.randint(0, num_classes, (n,)).astype("int64")

    def reader():
        for i in range(len(data)):
            yield data[i].reshape(3, 32, 32), int(labels[i])
    return reader


def train10():
    return _reader("train", 10)


def test10():
    return _reader("test", 10)


def train100():
    return _reader("train", 100)


def test100():
    return _reader("test", 100)
