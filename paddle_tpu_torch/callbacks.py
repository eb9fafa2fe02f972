"""The ``paddle.callbacks`` namespace (counterpart of
``paddle_tpu/callbacks.py``): the public path of ``hapi.callbacks``."""
from .hapi.callbacks import (  # noqa: F401
    Callback, ProgBarLogger, ModelCheckpoint, VisualDL, LRScheduler,
    EarlyStopping, ReduceLROnPlateau,
)

__all__ = ['Callback', 'ProgBarLogger', 'ModelCheckpoint', 'VisualDL',
           'LRScheduler', 'EarlyStopping', 'ReduceLROnPlateau']
