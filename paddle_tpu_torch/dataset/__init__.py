"""Built-in datasets (the port's copy of ``paddle_tpu/dataset/``;
reference: python/paddle/dataset/ -- mnist, cifar, imdb, imikolov,
movielens, uci_housing, wmt14/16, flowers, conll05, ...).

Each module reads its files from the local cache directory
``PADDLE_TPU_DATA_HOME`` (default ``~/.cache/paddle_tpu/dataset``, the JAX
package's too) where they are present, and otherwise yields deterministic
synthetic data with the real shapes and vocabulary sizes; nothing is
downloaded. Samples are host numpy data, drawn with numpy's RandomState
from ``common.rng_for``'s seeds: the same samples, in the same order, as
the JAX package's modules.
"""
from . import mnist
from . import cifar
from . import uci_housing
from . import imdb
from . import imikolov
from . import movielens
from . import wmt14
from . import wmt16
from . import flowers
from . import conll05
from . import sentiment
from . import mq2007
from . import voc2012
from . import image

__all__ = ["mnist", "cifar", "uci_housing", "imdb", "imikolov", "movielens",
           "wmt14", "wmt16", "flowers", "conll05", "sentiment", "mq2007",
           "voc2012", "image"]
