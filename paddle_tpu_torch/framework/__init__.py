"""paddle_tpu_torch.framework — ``save``/``load`` and the seed
(counterpart of ``paddle_tpu/framework``; the port has ``io.py``)."""
from .io import save, load  # noqa: F401
from ..core.rng import seed, get_seed  # noqa: F401

__all__ = ['save', 'load', 'seed', 'get_seed']
