"""MNIST (reference: python/paddle/dataset/mnist.py — idx-format loaders).
Local cache: standard idx files under <DATA_HOME>/mnist/."""
import gzip
import os
import struct

import numpy as np

from . import common

_N_TRAIN, _N_TEST = 60000, 10000


def _load_idx(images_path, labels_path):
    opener = gzip.open if images_path.endswith(".gz") else open
    with opener(images_path, "rb") as f:
        _, n, rows, cols = struct.unpack(">IIII", f.read(16))
        images = np.frombuffer(f.read(), np.uint8).reshape(n, rows * cols)
    with opener(labels_path, "rb") as f:
        struct.unpack(">II", f.read(8))
        labels = np.frombuffer(f.read(), np.uint8)
    return images.astype("float32") / 255.0 * 2.0 - 1.0, \
        labels.astype("int64")


def _reader(split, limit):
    name = "train" if split == "train" else "t10k"
    img_p = common.cache_path("mnist", "%s-images-idx3-ubyte.gz" % name)
    lab_p = common.cache_path("mnist", "%s-labels-idx1-ubyte.gz" % name)
    if os.path.exists(img_p) and os.path.exists(lab_p):
        images, labels = _load_idx(img_p, lab_p)
    else:
        common.synthetic_note("mnist")
        rng = common.rng_for("mnist", split)
        n = min(limit, 2048)
        images = rng.uniform(-1, 1, (n, 784)).astype("float32")
        labels = rng.randint(0, 10, (n,)).astype("int64")

    def reader():
        for i in range(len(images)):
            yield images[i], int(labels[i])
    return reader


def train():
    return _reader("train", _N_TRAIN)


def test():
    return _reader("test", _N_TEST)
