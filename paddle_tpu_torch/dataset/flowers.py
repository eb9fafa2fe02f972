"""paddle.dataset.flowers — 102-category flowers readers.

Counterpart of ``paddle_tpu/dataset/flowers.py``; Paddle's
python/paddle/dataset/flowers.py (reader_creator:74, train:120,
test:151, valid:180).  Samples are (CHW float32 image, int label).
"""
import numpy as np

from ..vision.datasets import Flowers

__all__ = ['train', 'test', 'valid']


def _creator(mode, use_xmap=True, cycle=False):
    ds = Flowers(mode=mode)

    def reader():
        while True:
            for i in range(len(ds)):
                img, label = ds[i]
                arr = np.asarray(img, np.float32)
                if arr.ndim == 3 and arr.shape[-1] in (1, 3):
                    arr = arr.transpose(2, 0, 1)     # HWC -> CHW
                yield arr, int(np.asarray(label).reshape(()))
            if not cycle:
                break

    return reader


def train(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _creator('train', use_xmap, cycle)


def test(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _creator('test', use_xmap, cycle)


def valid(mapper=None, buffered_size=1024, use_xmap=True):
    return _creator('valid', use_xmap)


def fetch():
    pass
