"""PASCAL VOC2012 segmentation (reference:
python/paddle/dataset/voc2012.py — samples are (image CHW uint8->float,
label mask HW int32) pairs from the SegmentationClass split).

Real path: <DATA_HOME>/VOC2012/ with JPEGImages/*.npy and
SegmentationClass/*.npy arrays plus ImageSets/Segmentation/{train,val,
trainval}.txt id lists (decoded-array cache of the reference tarball —
the package decodes no JPEG or PNG); otherwise deterministic
synthetic image/mask pairs.
"""
import os

import numpy as np

from . import common

__all__ = ["train", "test", "val"]

_N_CLASSES = 21
_SYN_SHAPE = (3, 32, 32)


def _root():
    return common.cache_path("VOC2012")


def _ids(split):
    path = os.path.join(_root(), "ImageSets", "Segmentation",
                        "%s.txt" % split)
    if os.path.exists(path):
        with open(path) as f:
            return [l.strip() for l in f if l.strip()]
    return None


def _reader(split, n=32):
    ids = _ids(split)
    if ids is not None:
        def reader():
            for name in ids:
                img = np.load(os.path.join(_root(), "JPEGImages",
                                           name + ".npy"))
                lab = np.load(os.path.join(_root(), "SegmentationClass",
                                           name + ".npy"))
                yield img.astype("float32"), lab.astype("int32")
        return reader
    common.synthetic_note("voc2012")
    rng = common.rng_for("voc2012", split)

    def reader():
        for _ in range(n):
            img = rng.randint(0, 255, _SYN_SHAPE).astype("float32")
            lab = rng.randint(0, _N_CLASSES,
                              _SYN_SHAPE[1:]).astype("int32")
            yield img, lab
    return reader


def train():
    """trainval ids in the reference's train reader."""
    return _reader("trainval")


def test():
    return _reader("train")


def val():
    return _reader("val")
