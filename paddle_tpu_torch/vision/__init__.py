"""Vision of the port (counterpart of ``paddle_tpu/vision``): the model
zoo, also re-exported here as the reference does (``vision.resnet50``,
``vision.LeNet``), the numpy transforms and the datasets (files on disk
or the synthetic fallback)."""
from . import datasets  # noqa: F401
from . import models  # noqa: F401
from . import transforms  # noqa: F401

from .models import *  # noqa: F401,F403
from .models import __all__ as _models_all

__all__ = ['datasets', 'models', 'transforms'] + list(_models_all)
