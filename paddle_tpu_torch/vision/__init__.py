"""Vision of the port (counterpart of ``paddle_tpu/vision``): the model
zoo, the numpy transforms and the datasets (files on disk or the
synthetic fallback)."""
from . import datasets  # noqa: F401
from . import models  # noqa: F401
from . import transforms  # noqa: F401

__all__ = ['datasets', 'models', 'transforms']
