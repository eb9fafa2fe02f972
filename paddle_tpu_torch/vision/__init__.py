"""Vision models of the port (counterpart of ``paddle_tpu/vision``; the
port has ``models``)."""
from . import models

__all__ = ['models']
