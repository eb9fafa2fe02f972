"""paddle.incubate parity namespace (counterpart of
``paddle_tpu/incubate``): the routed-expert layer ``SwitchMoE``.  The
reference's other re-exports (ring attention, the GPipe and host
embedding pieces) wait for the planes they belong to."""
from .moe import SwitchMoE

__all__ = ['SwitchMoE']
