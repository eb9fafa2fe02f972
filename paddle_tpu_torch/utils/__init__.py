"""paddle_tpu_torch.utils (counterpart of ``paddle_tpu/utils``):
``profiler`` (``ProfilerOptions``, ``Profiler``, ``get_profiler``).
The rest of the reference's ``utils`` is ROADMAP Queue 1 item 12."""
from . import profiler  # noqa: F401

__all__ = ['profiler']
