"""paddle.device namespace (counterpart of ``paddle_tpu/device.py``):
the public names of ``core/device.py``, where they live — the places,
``set_device``/``get_device`` and the ``is_compiled_with_*``
queries, which answer from torch."""
from .core.device import (  # noqa: F401
    CPUPlace, CUDAPinnedPlace, CUDAPlace, NPUPlace, TPUPlace, XPUPlace,
    device_count, get_cudnn_version, get_device, is_compiled_with_cuda,
    is_compiled_with_npu, is_compiled_with_xpu, set_device)

__all__ = ['get_cudnn_version', 'XPUPlace', 'is_compiled_with_xpu',
           'is_compiled_with_cuda', 'is_compiled_with_npu',
           'get_device', 'set_device']
