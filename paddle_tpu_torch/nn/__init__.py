"""Layers and functionals of the port (counterpart of ``paddle_tpu/nn``)."""
from . import functional
from .layer import Dropout, Embedding, LayerNorm, Linear

__all__ = ['functional', 'Dropout', 'Embedding', 'LayerNorm', 'Linear']
