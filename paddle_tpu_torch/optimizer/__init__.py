"""Optimizers of the port (counterpart of ``paddle_tpu/optimizer``; the
port has ``Optimizer``, ``Adam`` and ``AdamW``; the ``lr.py`` schedulers
wait)."""
from .adam import Adam, AdamW
from .optimizer import Optimizer

__all__ = ['Optimizer', 'Adam', 'AdamW']
