"""Optimizers of the port (counterpart of ``paddle_tpu/optimizer``)."""
from . import lr
from .adam import Adam, Adamax, AdamW, Lamb
from .dgc import DGCMomentum
from .optimizer import Optimizer
from .sgd_family import SGD, Adadelta, Adagrad, Lars, Momentum, RMSProp

__all__ = ['Optimizer', 'Adam', 'AdamW', 'Adamax', 'Lamb', 'SGD',
           'Momentum', 'Adagrad', 'Adadelta', 'RMSProp', 'Lars',
           'DGCMomentum', 'lr']
