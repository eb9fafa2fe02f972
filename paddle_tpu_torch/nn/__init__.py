"""Layers, functionals, initializers, gradient clipping and decoding of
the port (counterpart of ``paddle_tpu/nn``)."""
from . import clip, functional, initializer, layer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .decode import BeamSearchDecoder, Decoder, dynamic_decode
from .layer import *    # noqa: F401,F403

__all__ = (['clip', 'functional', 'initializer', 'ClipGradByValue',
            'ClipGradByNorm', 'ClipGradByGlobalNorm', 'Decoder',
            'BeamSearchDecoder', 'dynamic_decode'] + layer.__all__)
