"""paddle_tpu_torch.hapi (counterpart of ``paddle_tpu/hapi``; Paddle's
python/paddle/hapi): ``Model``, ``summary``, ``flops`` and the
callbacks."""
from .model import Model  # noqa: F401
from .summary import summary  # noqa: F401
from .flops import flops  # noqa: F401
from . import callbacks  # noqa: F401

__all__ = ['Model', 'summary', 'flops', 'callbacks']
