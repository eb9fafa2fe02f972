"""Device resolution: the CUDA card by default, the CPU only when asked.

Counterpart of ``paddle_tpu/core/device.py``.  A port entry point
(model, layer, KV cache) takes ``device=None`` and resolves it here.
With no card and no explicit device it raises: the port never quietly
runs on the CPU.  ``device='cpu'`` is how the tests run the plain
PyTorch versions of the kernels.  ``set_device('cpu')`` (the reference's
``paddle.set_device``) makes the CPU the default for ``device=None``
until ``set_device('gpu')`` or ``set_device(None)``; layers built
without a ``device`` argument (``nn.Transformer()``, ``nn.LSTM(...)``)
and ``to_tensor`` take that default.

The places (``paddle_tpu/core/device.py:11-116``) name devices as the
reference does: ``CUDAPlace(i)`` is card ``i``, and ``TPUPlace``,
``XPUPlace`` and ``NPUPlace``, which the reference maps onto its
accelerator, map onto the card here; ``CUDAPinnedPlace`` is the CPU.
Any entry point's ``device`` (or ``place``) takes one.  The queries
(``device_count``, ``is_compiled_with_cuda``, ``get_cudnn_version``)
answer from torch.
"""
import torch

__all__ = ['resolve_device', 'set_device', 'get_device', 'Place',
           'CPUPlace', 'CUDAPlace', 'TPUPlace', 'XPUPlace', 'NPUPlace',
           'CUDAPinnedPlace', 'get_place', 'device_count',
           'is_compiled_with_cuda', 'is_compiled_with_xpu',
           'is_compiled_with_npu', 'get_cudnn_version']


class Place:
    """A device as the reference names it: ``kind`` ``'cpu'`` or
    ``'gpu'`` and an index."""

    def __init__(self, kind, device_id=0):
        self.kind = kind
        self.device_id = device_id

    def __repr__(self):
        return f'Place({self.kind}:{self.device_id})'

    def __eq__(self, other):
        return (isinstance(other, Place) and self.kind == other.kind
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.kind, self.device_id))

    def torch_device(self):
        if self.kind == 'cpu':
            return torch.device('cpu')
        return torch.device('cuda', self.device_id)


def CPUPlace():
    return Place('cpu')


def CUDAPlace(device_id=0):
    return Place('gpu', device_id)


# the reference's accelerator places: the card here
TPUPlace = XPUPlace = NPUPlace = CUDAPlace


def CUDAPinnedPlace():
    """Pinned host memory: the CPU place, as in the reference."""
    return Place('cpu')


def get_place():
    """The default device as a ``Place``: ``set_device``'s choice, else
    the card, else the CPU."""
    d = _default
    if d is None:
        d = torch.device('cuda', torch.cuda.current_device()) \
            if torch.cuda.is_available() else torch.device('cpu')
    return Place('cpu') if d.type == 'cpu' else Place('gpu', d.index or 0)


def device_count():
    """The cards the default placement can use, else 1 (the CPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def is_compiled_with_cuda():
    return torch.version.cuda is not None


def is_compiled_with_xpu():
    xpu = getattr(torch, 'xpu', None)
    return bool(xpu is not None and xpu.is_available())


def is_compiled_with_npu():
    return False


def get_cudnn_version():
    """cuDNN's version as an int, None without it."""
    if not torch.backends.cudnn.is_available():
        return None
    return torch.backends.cudnn.version()

_default = None     # set_device's choice; None: the card, or raise


def set_device(device):
    """Make ``device`` ('cpu', 'gpu', 'gpu:1', 'cuda:0' or a
    ``torch.device``) the default of every ``device=None``; None goes
    back to the card-or-raise rule.  Returns the ``torch.device``."""
    global _default
    if device is None:
        _default = None
        return None
    if isinstance(device, Place):
        device = device.torch_device()
    if isinstance(device, str):
        kind, _, idx = device.partition(':')
        kind = 'cuda' if kind == 'gpu' else kind
        device = f'{kind}:{idx}' if idx else kind
    _default = torch.device(device)
    return _default


def get_device():
    """The default device as the reference names it: ``'cpu'`` or
    ``'gpu:<index>'``."""
    d = resolve_device()
    return 'cpu' if d.type == 'cpu' else f'gpu:{d.index or 0}'


def resolve_device(device=None):
    """``torch.device`` for an entry point's ``device`` argument (a
    name, a ``torch.device`` or a ``Place``)."""
    if isinstance(device, Place):
        return device.torch_device()
    if device is not None:
        return torch.device(device)
    if _default is not None:
        return _default
    if not torch.cuda.is_available():
        raise RuntimeError(
            'paddle_tpu_torch runs on a CUDA device by default and none '
            "is available; pass device='cpu' (or call "
            "set_device('cpu')) to run the plain PyTorch versions on the "
            'CPU')
    return torch.device('cuda', torch.cuda.current_device())
