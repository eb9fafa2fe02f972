from . import (activation, common, container, conv, distance, loss, norm,
               pooling, rnn, transformer, vision)
from .activation import *    # noqa: F401,F403
from .common import *        # noqa: F401,F403
from .container import *     # noqa: F401,F403
from .conv import *          # noqa: F401,F403
from .distance import *      # noqa: F401,F403
from .layers import Layer, ParamAttr, create_parameter
from .loss import *          # noqa: F401,F403
from .norm import *          # noqa: F401,F403
from .pooling import *       # noqa: F401,F403
from .rnn import *           # noqa: F401,F403
from .transformer import *   # noqa: F401,F403
from .vision import *        # noqa: F401,F403

__all__ = (['Layer', 'ParamAttr', 'create_parameter'] + activation.__all__
           + common.__all__ + container.__all__ + conv.__all__
           + loss.__all__ + norm.__all__ + pooling.__all__ + rnn.__all__
           + transformer.__all__ + distance.__all__ + vision.__all__)
