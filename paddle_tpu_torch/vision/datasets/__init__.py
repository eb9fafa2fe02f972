"""Vision datasets (counterpart of ``paddle_tpu/vision/datasets``; files
on disk or the synthetic fallback, never a download)."""
from .folder import DatasetFolder, ImageFolder  # noqa: F401
from .mnist import MNIST, FashionMNIST  # noqa: F401
from .cifar import Cifar10, Cifar100  # noqa: F401
from .flowers import Flowers  # noqa: F401
from .voc2012 import VOC2012  # noqa: F401

__all__ = ['DatasetFolder', 'ImageFolder', 'MNIST', 'FashionMNIST',
           'Cifar10', 'Cifar100', 'Flowers', 'VOC2012']
