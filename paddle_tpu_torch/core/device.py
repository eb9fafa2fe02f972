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
"""
import torch

__all__ = ['resolve_device', 'set_device', 'get_device']

_default = None     # set_device's choice; None: the card, or raise


def set_device(device):
    """Make ``device`` ('cpu', 'gpu', 'gpu:1', 'cuda:0' or a
    ``torch.device``) the default of every ``device=None``; None goes
    back to the card-or-raise rule.  Returns the ``torch.device``."""
    global _default
    if device is None:
        _default = None
        return None
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
    """``torch.device`` for an entry point's ``device`` argument."""
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
