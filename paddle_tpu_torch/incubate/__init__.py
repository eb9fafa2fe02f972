"""paddle.incubate parity namespace (counterpart of
``paddle_tpu/incubate``): ``flash_attention`` (the hand-written
kernels), the routed-expert layer ``SwitchMoE`` and ``checkpoint``
(``auto_checkpoint``).  The reference's other re-exports (ring
attention, the GPipe and host embedding pieces) wait for the planes
they belong to."""
from ..ops.flash_attention import flash_attention
from .moe import SwitchMoE
from . import checkpoint  # noqa: F401

__all__ = ['flash_attention', 'SwitchMoE', 'checkpoint']
