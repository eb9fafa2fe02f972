"""Fault-tolerant training (counterpart of ``paddle_tpu/resilience``):
the port has the NaN sentinel; checkpoint manifests, graceful shutdown,
retry, chaos, the watchdog, plan generation and the supervisor wait for
later slices."""
from .sentinel import NanSentinel, finite_step, guard_update

__all__ = ['NanSentinel', 'finite_step', 'guard_update']
