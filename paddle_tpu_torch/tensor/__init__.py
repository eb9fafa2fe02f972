"""The tensor op library (counterpart of ``paddle_tpu/tensor``): every name
of the reference's ``__all__``, each casting its float inputs through the
AMP policy under the reference's op name.

The reference grafts its ops onto its own ``Tensor`` class as methods
(``paddle_tpu/tensor/__init__.py:34-85``).  The port's tensor is
``torch.Tensor`` and is left as it is: grafting would change every torch
program in the process (``.sum(axis=)``, ``.astype``, ``stop_gradient``).
Call the functions (``paddle.sum(x, axis=1)``) where the reference's
code calls a method that torch lacks or gives another meaning (ROADMAP
Queue 3).
"""
from . import (array, creation, linalg, logic, manipulation, math, random,
               search, stat, to_string as _to_string_mod)
from .array import *         # noqa: F401,F403
from .creation import *      # noqa: F401,F403
from .linalg import *        # noqa: F401,F403
from .logic import *         # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *          # noqa: F401,F403
from .random import *        # noqa: F401,F403
from .search import *        # noqa: F401,F403
from .stat import *          # noqa: F401,F403
from .to_string import *     # noqa: F401,F403

__all__ = list(dict.fromkeys(
    creation.__all__ + math.__all__ + manipulation.__all__ + linalg.__all__
    + logic.__all__ + random.__all__ + search.__all__ + stat.__all__
    + array.__all__ + _to_string_mod.__all__))
