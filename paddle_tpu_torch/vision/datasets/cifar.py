"""Cifar10 / Cifar100 datasets.

Reference analogue: python/paddle/vision/datasets/cifar.py:99 (Cifar10),
:231 (Cifar100).  Parses the standard python-pickle tar.gz when
`data_file` is given; synthetic fallback otherwise (no download).
Counterpart of ``paddle_tpu/vision/datasets/cifar.py``.
"""
import os
import pickle
import tarfile

import numpy as np

from ...io import Dataset
from ._synthetic import synthetic_images

__all__ = ['Cifar10', 'Cifar100']


class Cifar10(Dataset):
    NUM_CLASSES = 10
    _SYNTH_SEED = 211
    _LABEL_KEYS = (b'labels', 'labels')

    def __init__(self, data_file=None, mode='train', transform=None,
                 download=True, backend=None):
        mode = mode.lower()
        assert mode in ('train', 'test'), \
            "mode should be 'train' or 'test', but got {}".format(mode)
        self.mode = mode
        self.transform = transform
        self.backend = backend or 'numpy'
        if data_file and os.path.exists(data_file):
            self.data = self._load_tar(data_file, mode)
        else:
            n = 8192 if mode == 'train' else 2048
            seed = self._SYNTH_SEED + (0 if mode == 'train' else 1)
            images, labels = synthetic_images(
                n, (32, 32, 3), self.NUM_CLASSES, seed)
            self.data = [(images[i].transpose(2, 0, 1).reshape(-1),
                          int(labels[i])) for i in range(n)]

    def _member_filter(self, name, mode):
        want = 'data_batch' if mode == 'train' else 'test_batch'
        return want in name

    def _load_tar(self, path, mode):
        out = []
        with tarfile.open(path, mode='r') as tf:
            names = [n for n in tf.getnames()
                     if self._member_filter(n, mode)]
            for name in sorted(names):
                batch = pickle.load(tf.extractfile(name), encoding='bytes')
                data = batch[b'data'] if b'data' in batch else batch['data']
                labels = None
                for k in self._LABEL_KEYS:
                    if k in batch:
                        labels = batch[k]
                        break
                for i in range(len(labels)):
                    out.append((data[i], int(labels[i])))
        return out

    def __getitem__(self, idx):
        image, label = self.data[idx]
        image = np.asarray(image, dtype=np.uint8)
        image = image.reshape(3, 32, 32).transpose(1, 2, 0)
        if self.transform is not None:
            image = self.transform(image)
        return image, np.array([label]).astype(np.int64)

    def __len__(self):
        return len(self.data)


class Cifar100(Cifar10):
    NUM_CLASSES = 100
    _SYNTH_SEED = 221
    _LABEL_KEYS = (b'fine_labels', 'fine_labels')

    def _member_filter(self, name, mode):
        return name.endswith(mode)  # files named 'train' / 'test'
