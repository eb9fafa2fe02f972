"""MNIST / FashionMNIST datasets.

Reference analogue: python/paddle/vision/datasets/mnist.py:74 (class MNIST).
Same constructor; parses standard idx-ubyte files when paths are given,
otherwise serves deterministic synthetic digits (no download).
Counterpart of ``paddle_tpu/vision/datasets/mnist.py``.
"""
import gzip
import os
import struct

import numpy as np

from ...io import Dataset
from ._synthetic import synthetic_images

__all__ = ['MNIST', 'FashionMNIST']


def _read_idx(path):
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rb') as f:
        magic = struct.unpack('>I', f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack('>' + 'I' * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


class MNIST(Dataset):
    NUM_CLASSES = 10
    _SYNTH_SEED = 101

    def __init__(self, image_path=None, label_path=None, mode='train',
                 transform=None, download=True, backend=None):
        mode = mode.lower()
        assert mode in ('train', 'test'), \
            "mode should be 'train' or 'test', but got {}".format(mode)
        if backend not in (None, 'cv2', 'pil', 'numpy'):
            raise ValueError('unsupported backend: {}'.format(backend))
        self.mode = mode
        self.transform = transform
        self.backend = backend or 'numpy'
        if image_path and label_path and os.path.exists(image_path) \
                and os.path.exists(label_path):
            self.images = _read_idx(image_path)
            if self.images.ndim == 3:
                self.images = self.images[:, :, :, None]
            self.labels = _read_idx(label_path).astype(np.int64)
        else:
            n = 8192 if mode == 'train' else 2048
            seed = self._SYNTH_SEED + (0 if mode == 'train' else 1)
            self.images, self.labels = synthetic_images(
                n, (28, 28, 1), self.NUM_CLASSES, seed)

    def __getitem__(self, idx):
        image, label = self.images[idx], self.labels[idx]
        if self.transform is not None:
            image = self.transform(image)
        return image, np.array([label]).astype(np.int64)

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    """Same on-disk format as MNIST; different synthetic seed."""
    _SYNTH_SEED = 131
