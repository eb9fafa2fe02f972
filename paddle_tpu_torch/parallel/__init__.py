"""Training step of the port (counterpart of ``paddle_tpu/parallel``;
the port has the single-device ``ParallelTrainer``)."""
from .engine import ParallelTrainer

__all__ = ['ParallelTrainer']
