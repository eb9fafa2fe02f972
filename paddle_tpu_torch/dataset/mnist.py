"""paddle.dataset.mnist — fluid-era MNIST reader creators.

Counterpart of ``paddle_tpu/dataset/mnist.py``; Paddle's
python/paddle/dataset/mnist.py (reader_creator:43, train:98, test:120).
Samples are (784-float32 in [-1, 1], int label) — the reference's
`img/255*2-1` normalization — served from the vision.datasets.MNIST
loader (idx files when present, deterministic synthetic otherwise).
"""
import numpy as np

from ..vision.datasets import MNIST

__all__ = ['train', 'test']


def _creator(mode):
    ds = MNIST(mode=mode)

    def reader():
        for i in range(len(ds)):
            img, label = ds[i]
            flat = np.asarray(img, np.float32).reshape(-1)
            # vision.MNIST serves raw 0..255 uint8 pixels
            flat = flat / 255.0 * 2.0 - 1.0
            yield flat, int(np.asarray(label).reshape(()))

    return reader


def train():
    """-> reader of (784-float32 in [-1,1], int label), 60k samples
    (reference mnist.py:98)."""
    return _creator('train')


def test():
    """-> reader over the 10k-sample test split (reference
    mnist.py:120)."""
    return _creator('test')


def fetch():
    """Reference mnist.py:141 pre-downloads; no-op here (synthetic or
    pre-seeded files)."""
