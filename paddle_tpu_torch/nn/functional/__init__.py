from .activation import gelu, softmax, tanh
from .common import dropout, embedding, embedding_prefix, linear
from .loss import cross_entropy
from .norm import layer_norm

__all__ = ['gelu', 'softmax', 'tanh', 'dropout', 'embedding',
           'embedding_prefix', 'linear', 'cross_entropy', 'layer_norm']
