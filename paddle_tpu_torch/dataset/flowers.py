"""Oxford-102 flowers (reference: python/paddle/dataset/flowers.py)."""
import numpy as np

from . import common

CLASSES = 102


def _reader(split, n=256):
    import os
    # real path: a decoded npz cache (images [N,3,H,W] f32, labels [N])
    # — the reference decodes the 102flowers tarball + setid.mat; image
    # decoding is out of scope here, so the cache holds decoded arrays
    path = common.cache_path("flowers", "%s.npz" % split)
    if os.path.exists(path):
        with np.load(path) as z:
            images, labels = z["images"], z["labels"]

        def reader():
            for img, lab in zip(images, labels):
                yield img.astype("float32"), int(lab)
        return reader
    common.synthetic_note("flowers")
    rng = common.rng_for("flowers", split)

    def reader():
        for _ in range(n):
            img = rng.rand(3, 224, 224).astype("float32")
            yield img, int(rng.randint(0, CLASSES))
    return reader


def train(mapper=None, buffered_size=1024, use_xmap=True):
    return _reader("train")


def test(mapper=None, buffered_size=1024, use_xmap=True):
    return _reader("test")


def valid(mapper=None, buffered_size=1024, use_xmap=True):
    return _reader("valid")
