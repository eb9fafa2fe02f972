"""paddle.dataset.cifar — fluid-era CIFAR reader creators.

Counterpart of ``paddle_tpu/dataset/cifar.py``; Paddle's
python/paddle/dataset/cifar.py (reader_creator:49,
train10/test10/train100/test100).  Samples are (3072-float32 in [0, 1]
CHW-flat, int label) — the reference's `sample/255` convention.
"""
import numpy as np

from ..vision.datasets import Cifar10, Cifar100

__all__ = ['train10', 'test10', 'train100', 'test100']


def _creator(cls, mode, cycle=False):
    ds = cls(mode=mode)

    def reader():
        while True:
            for i in range(len(ds)):
                img, label = ds[i]
                arr = np.asarray(img)
                # scaling decided by DTYPE, not per-image content: the
                # loader serves raw uint8 pixels; a float transform
                # output is assumed already scaled
                flat = arr.astype(np.float32).reshape(-1)
                if np.issubdtype(arr.dtype, np.integer):
                    flat = flat / 255.0
                yield flat, int(np.asarray(label).reshape(()))
            if not cycle:
                break

    return reader


def train10(cycle=False):
    """CIFAR-10 train reader (reference cifar.py:76)."""
    return _creator(Cifar10, 'train', cycle)


def test10(cycle=False):
    """CIFAR-10 test reader (reference cifar.py:95)."""
    return _creator(Cifar10, 'test', cycle)


def train100():
    """CIFAR-100 train reader (reference cifar.py:114)."""
    return _creator(Cifar100, 'train')


def test100():
    """CIFAR-100 test reader (reference cifar.py:132)."""
    return _creator(Cifar100, 'test')


def fetch():
    pass
