from . import rng
from .device import resolve_device

__all__ = ['resolve_device', 'rng']
