"""Flowers-102 dataset.

Reference analogue: python/paddle/vision/datasets/flowers.py (class
Flowers); counterpart of ``paddle_tpu/vision/datasets/flowers.py``.
File-backed loading needs scipy .mat labels, which the reference does
without; the synthetic split (64x64x3, 102 classes, 1024/256/512
images) is the reference's, image for image.
"""
import numpy as np

from ...io import Dataset
from ._synthetic import synthetic_images

__all__ = ['Flowers']

_SPLIT_N = {'train': 1024, 'valid': 256, 'test': 512}


class Flowers(Dataset):
    NUM_CLASSES = 102

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode='train', transform=None, download=True, backend=None):
        mode = mode.lower()
        assert mode in ('train', 'valid', 'test'), \
            "mode should be 'train', 'valid' or 'test', got {}".format(mode)
        self.mode = mode
        self.transform = transform
        self.backend = backend or 'numpy'
        seed = 311 + list(_SPLIT_N).index(mode)
        self.images, self.labels = synthetic_images(
            _SPLIT_N[mode], (64, 64, 3), self.NUM_CLASSES, seed)

    def __getitem__(self, idx):
        image, label = self.images[idx], self.labels[idx]
        if self.transform is not None:
            image = self.transform(image)
        return image, np.array([label]).astype(np.int64)

    def __len__(self):
        return len(self.images)
