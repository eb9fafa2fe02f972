"""Tensor ops of the port (counterpart of ``paddle_tpu/tensor``): the
ones its models, losses and sequence layers use, each casting its
float inputs through the AMP policy under the reference's op name."""
from . import creation, logic, manipulation, math, search
from .creation import *      # noqa: F401,F403
from .logic import *         # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *          # noqa: F401,F403
from .search import *        # noqa: F401,F403

__all__ = (creation.__all__ + logic.__all__ + manipulation.__all__
           + math.__all__ + search.__all__)
