"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package ``paddle_tpu`` stays the reference; this package mirrors
its module paths and public names so each counterpart is easy to find,
and keeps its state-dict keys and shapes (``Linear.weight`` is
``[in, out]``) so one set of weights loads into both.

Entry points run on the CUDA device unless the caller passes
``device='cpu'`` (or calls ``set_device('cpu')``); with no card and no
explicit device they raise (``core.device.resolve_device``).  Every TPU
kernel on a ported path is a hand-written Hopper kernel under
``csrc/``, built with ``nvcc`` at first use (``ops._build``); on a CPU
tensor its wrapper runs the plain PyTorch twin instead.

The top level carries what a Paddle script reaches for as
``paddle.<name>``: ``seed``, ``set_device``, ``ParamAttr``, every tensor
op of ``tensor``, the dtype names, the places and device queries,
``grad`` and the grad-mode switches (``core.autograd``), ``Tensor``
(``torch.Tensor``) and ``Parameter`` (``torch.nn.Parameter``), the
high-level API (``Model``, ``summary``, ``flops``, ``save``, ``load``),
the fluid-era ``batch``, and the ``nn``, ``optimizer``, ``amp``, ``io``,
``metric``, ``hapi``, ``callbacks``, ``jit``, ``static``, ``framework``,
``vision``, ``inference``, ``reader``, ``dataset``, ``autograd``,
``regularizer``, ``parallel``, ``models``, ``distributed``, ``device``,
``ops``, ``profiler``, ``quantization`` and ``utils`` packages
(none of which starts a thread, a process group or a CUDA context on
import).  ``models`` is imported at its first use as
``paddle_tpu_torch.models``: a process that serves a saved model (an
``inference.Predictor``) never loads the model zoo's code.

The package imports ``torch``, numpy and the standard library only —
never ``jax`` and nothing of ``paddle_tpu``.
"""
import torch as _torch

from .core.device import (  # noqa: F401
    CPUPlace, CUDAPinnedPlace, CUDAPlace, NPUPlace, TPUPlace, XPUPlace,
    device_count, get_cudnn_version, get_device, get_place,
    is_compiled_with_cuda, is_compiled_with_npu, is_compiled_with_xpu,
    resolve_device, set_device)
from .core.autograd import (  # noqa: F401
    enable_grad, grad, is_grad_enabled, no_grad, set_grad_enabled)
from .core.dtype import (  # noqa: F401
    bfloat16, bool_, complex64, complex128, dtype, float16, float32,
    float64, get_default_dtype, int8, int16, int32, int64,
    set_default_dtype, uint8)
from .core.dtype import bool_ as bool  # noqa: A001
from .core.rng import get_cuda_rng_state, seed, set_cuda_rng_state
from . import amp, autograd, nn, optimizer, tensor  # noqa: F401
from . import resilience  # noqa: F401
from . import telemetry  # noqa: F401
from . import framework, io, jit, metric, static, vision  # noqa: F401
from . import callbacks, hapi  # noqa: F401
from . import dataset, inference, reader  # noqa: F401
from . import distributed, parallel, regularizer  # noqa: F401
from . import incubate  # noqa: F401
from . import device, ops, profiler, quantization, utils  # noqa: F401
from .batch import batch
from .distributed.parallel import DataParallel
from .framework import ComplexTensor
from .framework.io import load, save
from .hapi import Model, flops, summary
from .nn.layer.layers import ParamAttr, create_parameter
from .tensor import *  # noqa: F401,F403
from .tensor.manipulation import crop as crop_tensor

# the tensor is PyTorch's own; the reference's methods are not grafted
# onto it (tensor/__init__.py)
Tensor = _torch.Tensor
VarBase = _torch.Tensor
Parameter = _torch.nn.Parameter


def in_dynamic_mode():
    """Always True: the port has no static mode (ROADMAP item 12)."""
    return True


in_dygraph_mode = in_dynamic_mode


def __getattr__(name):
    """``models`` on first use (module docstring)."""
    if name == 'models':
        import importlib
        return importlib.import_module('.models', __name__)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')

__all__ = (['resolve_device', 'set_device', 'get_device', 'seed',
            'ParamAttr', 'create_parameter', 'amp', 'nn', 'optimizer',
            'tensor', 'resilience', 'telemetry', 'framework', 'io', 'jit',
            'metric', 'static', 'vision', 'hapi', 'callbacks', 'Model',
            'summary', 'flops', 'save', 'load', 'inference', 'reader',
            'dataset', 'batch', 'autograd', 'regularizer', 'parallel',
            'distributed', 'incubate', 'device', 'ops', 'profiler',
            'quantization', 'utils', 'DataParallel', 'ComplexTensor',
            'Tensor', 'Parameter',
            'VarBase', 'no_grad', 'enable_grad', 'is_grad_enabled',
            'set_grad_enabled', 'grad', 'dtype', 'bool', 'float16',
            'bfloat16', 'float32', 'float64', 'int8', 'int16', 'int32',
            'int64', 'uint8', 'bool_', 'complex64', 'complex128',
            'set_default_dtype', 'get_default_dtype', 'CPUPlace',
            'CUDAPlace', 'TPUPlace', 'XPUPlace', 'NPUPlace',
            'CUDAPinnedPlace', 'get_place', 'device_count',
            'is_compiled_with_cuda', 'is_compiled_with_xpu',
            'is_compiled_with_npu', 'get_cudnn_version',
            'get_cuda_rng_state', 'set_cuda_rng_state', 'crop_tensor',
            'in_dynamic_mode', 'in_dygraph_mode'] + tensor.__all__)
