"""Common functionals (counterpart of
``paddle_tpu/nn/functional/common.py``; the port has ``linear``,
``embedding`` and ``embedding_prefix``).  Each casts its inputs through
the AMP policy under the reference's op name."""
import torch.nn.functional as TF

from ...amp import amp_cast

__all__ = ['linear', 'embedding', 'embedding_prefix']


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with paddle's ``weight [in, out]``."""
    x, weight, bias = amp_cast('linear', x, weight, bias)
    return TF.linear(x, weight.t(), bias)


def embedding(x, weight):
    """Row lookup ``weight[x]``."""
    x, weight = amp_cast('embedding', x, weight)
    return TF.embedding(x, weight)


def embedding_prefix(weight, length):
    """The first ``length`` rows of an embedding table: the training
    path's position embedding, ``weight[:length]``."""
    weight, = amp_cast('embedding_prefix', weight)
    return weight[:length]
