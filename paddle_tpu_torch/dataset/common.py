"""The datasets' cache directory and synthetic streams' seeds (the port's
copy of ``paddle_tpu/dataset/common.py``). ``PADDLE_TPU_DATA_HOME`` (by
default ``~/.cache/paddle_tpu/dataset``) is the JAX package's variable and
directory, so one cache serves both packages."""
import os

import numpy as np

DATA_HOME = os.environ.get(
    "PADDLE_TPU_DATA_HOME",
    os.path.join(os.path.expanduser("~"), ".cache", "paddle_tpu", "dataset"))


def cache_path(*parts):
    return os.path.join(DATA_HOME, *parts)


def has_cache(*parts):
    return os.path.exists(cache_path(*parts))


def synthetic_note(name):
    if os.environ.get("PADDLE_TPU_DATASET_VERBOSE"):
        print("[paddle_tpu_torch.dataset] %s: no local cache at %s — serving "
              "deterministic synthetic data" % (name, DATA_HOME))


def rng_for(name, split):
    # stable across processes: Python's str hash is randomized per process
    # (PYTHONHASHSEED), which made every synthetic dataset — and every
    # loss-decrease assertion over one — a fresh dice roll per test run
    import zlib
    seed = zlib.crc32(("%s/%s" % (name, split)).encode()) % (2 ** 31)
    return np.random.RandomState(seed)
