"""paddle.dataset — the fluid-era reader-creator data stack (counterpart
of ``paddle_tpu/dataset``; Paddle's python/paddle/dataset).

Each module exposes train()/test() reader creators yielding plain
numpy/python samples; compose them with paddle.reader decorators and
paddle.batch, then feed a trainer — the classic 1.x input pipeline.
The samples come from the port's ``vision.datasets`` (files already on
disk, else the reference's deterministic synthetic fallback); nothing
is downloaded, and ``common.download`` raises for a missing file.  The
text half (imdb, imikolov, movielens, uci_housing, conll05, wmt14,
wmt16) wraps the reference's ``text`` package and waits for it (ROADMAP
Queue 1 item 12).
"""
from . import common      # noqa: F401
from . import mnist       # noqa: F401
from . import cifar       # noqa: F401
from . import flowers     # noqa: F401
from . import voc2012     # noqa: F401
from . import image       # noqa: F401

__all__ = ['common', 'mnist', 'cifar', 'flowers', 'voc2012', 'image']
