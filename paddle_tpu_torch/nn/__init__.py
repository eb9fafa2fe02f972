"""Layers, functionals and gradient clipping of the port (counterpart
of ``paddle_tpu/nn``)."""
from . import clip, functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import Dropout, Embedding, LayerNorm, Linear

__all__ = ['clip', 'functional', 'Dropout', 'Embedding', 'LayerNorm',
           'Linear', 'ClipGradByValue', 'ClipGradByNorm',
           'ClipGradByGlobalNorm']
