"""Dataset readers with the reference's generator API.

The port's copy of ``paddle_tpu/datasets/__init__.py``.

Reference: python/paddle/dataset/ (mnist, cifar, imdb, uci_housing,
flowers, ...) — each module exposes train()/test() returning sample
generators, plus paddle.batch/shuffle decorators (reader_decorator).

Nothing is downloaded: the data is deterministic SYNTHETIC with the
real datasets' shapes/vocab/statistics (documented per module), the
same samples the JAX package's readers yield. Training-loop code
written against the reference API runs unchanged; for real data, point
the Dataset / DataLoader pipeline (paddle_tpu_torch.dataset,
paddle_tpu_torch.reader) at your files instead.
"""

from . import mnist
from . import uci_housing
from . import imdb
from . import cifar
from . import wmt14
from . import wmt16
from . import movielens
from . import conll05
from . import imikolov
from . import sentiment
from . import flowers
from . import voc2012
from . import mq2007
from .common import batch, shuffle, cache, firstn, map_readers

__all__ = ["mnist", "uci_housing", "imdb", "cifar", "batch", "shuffle"]
