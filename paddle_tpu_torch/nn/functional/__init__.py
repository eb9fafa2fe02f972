from .activation import gelu
from .common import embedding, embedding_prefix, linear
from .loss import cross_entropy
from .norm import layer_norm

__all__ = ['gelu', 'embedding', 'embedding_prefix', 'linear',
           'cross_entropy', 'layer_norm']
