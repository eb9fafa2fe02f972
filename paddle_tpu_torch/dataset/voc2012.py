"""paddle.dataset.voc2012 — segmentation readers.

Counterpart of ``paddle_tpu/dataset/voc2012.py``; Paddle's
python/paddle/dataset/voc2012.py (reader_creator:43, train:62, test:73,
val:84).  Samples are (CHW float32 image, HW int32 label mask).
"""
import numpy as np

from ..vision.datasets import VOC2012

__all__ = ['train', 'test', 'val']


def _creator(mode):
    ds = VOC2012(mode=mode)

    def reader():
        for i in range(len(ds)):
            img, mask = ds[i]
            arr = np.asarray(img, np.float32)
            if arr.ndim == 3 and arr.shape[-1] in (1, 3):
                arr = arr.transpose(2, 0, 1)
            yield arr, np.asarray(mask, np.int32)

    return reader


def train():
    return _creator('train')


def test():
    return _creator('test')


def val():
    return _creator('valid')


def fetch():
    pass
