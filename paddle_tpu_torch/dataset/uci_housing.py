"""UCI housing regression (reference: python/paddle/dataset/uci_housing.py).
Local cache: housing.data under <DATA_HOME>/uci_housing/."""
import os

import numpy as np

from . import common

FEATURE_NUM = 13


def _load():
    path = common.cache_path("uci_housing", "housing.data")
    if os.path.exists(path):
        data = np.loadtxt(path)
    else:
        common.synthetic_note("uci_housing")
        rng = common.rng_for("uci_housing", "all")
        x = rng.rand(506, FEATURE_NUM)
        w = rng.rand(FEATURE_NUM, 1)
        y = x @ w + 0.1 * rng.randn(506, 1)
        data = np.concatenate([x, y], axis=1)
    feats = data[:, :FEATURE_NUM]
    # normalize like the reference (max/min/avg per feature)
    mx, mn, avg = feats.max(0), feats.min(0), feats.mean(0)
    feats = (feats - avg) / np.maximum(mx - mn, 1e-6)
    return feats.astype("float32"), data[:, -1:].astype("float32")


def _reader(split):
    x, y = _load()
    split_idx = int(len(x) * 0.8)
    if split == "train":
        x, y = x[:split_idx], y[:split_idx]
    else:
        x, y = x[split_idx:], y[split_idx:]

    def reader():
        for i in range(len(x)):
            yield x[i], y[i]
    return reader


def train():
    return _reader("train")


def test():
    return _reader("test")
