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
``paddle.<name>``: ``seed``, ``set_device``, ``ParamAttr``, the tensor
ops of ``tensor`` (``to_tensor``, ``concat``, ``expand``, ...), the
high-level API (``Model``, ``summary``, ``flops``, ``save``, ``load``),
and the ``nn``, ``optimizer``, ``amp``, ``io``, ``metric``, ``hapi``,
``callbacks``, ``jit``, ``static``, ``framework`` and ``vision``
packages.

The package imports ``torch``, numpy and the standard library only —
never ``jax`` and nothing of ``paddle_tpu``.
"""
from .core.device import get_device, resolve_device, set_device
from .core.rng import seed
from . import amp, nn, optimizer, tensor  # noqa: F401
from . import resilience  # noqa: F401
from . import telemetry  # noqa: F401
from . import framework, io, jit, metric, static, vision  # noqa: F401
from . import callbacks, hapi  # noqa: F401
from .framework.io import load, save
from .hapi import Model, flops, summary
from .nn.layer.layers import ParamAttr, create_parameter
from .tensor import *  # noqa: F401,F403

__all__ = (['resolve_device', 'set_device', 'get_device', 'seed',
            'ParamAttr', 'create_parameter', 'amp', 'nn', 'optimizer',
            'tensor', 'resilience', 'telemetry', 'framework', 'io', 'jit',
            'metric', 'static', 'vision', 'hapi', 'callbacks', 'Model',
            'summary',
            'flops', 'save', 'load'] + tensor.__all__)
