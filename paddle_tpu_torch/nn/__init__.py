"""Layers, functionals, initializers, gradient clipping, weight and
spectral normalisation and decoding of the port (counterpart of
``paddle_tpu/nn``)."""
from . import clip, functional, initializer, layer, utils
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .decode import BeamSearchDecoder, Decoder, dynamic_decode
from .layer import *    # noqa: F401,F403
from .layer import (activation, common, container, conv, distance,  # noqa
                    layers, loss, norm, pooling, rnn, transformer, vision)
from .utils import remove_weight_norm, spectral_norm, weight_norm

__all__ = (['clip', 'functional', 'initializer', 'utils', 'ClipGradByValue',
            'ClipGradByNorm', 'ClipGradByGlobalNorm', 'Decoder',
            'BeamSearchDecoder', 'dynamic_decode', 'weight_norm',
            'remove_weight_norm', 'spectral_norm'] + layer.__all__)
