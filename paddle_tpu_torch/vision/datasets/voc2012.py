"""VOC2012 segmentation dataset.

Reference analogue: python/paddle/vision/datasets/voc2012.py (class
VOC2012) — (image, segmentation-mask) pairs.  Synthetic fallback emits
blocky class-region masks so segmentation losses have real structure.
"""
import numpy as np

from ...io import Dataset

__all__ = ['VOC2012']

_SPLIT_N = {'train': 512, 'valid': 128, 'test': 128}


class VOC2012(Dataset):
    NUM_CLASSES = 21  # 20 object classes + background

    def __init__(self, data_file=None, mode='train', transform=None,
                 download=True, backend=None):
        mode = mode.lower()
        assert mode in ('train', 'valid', 'test'), \
            "mode should be 'train', 'valid' or 'test', got {}".format(mode)
        self.mode = mode
        self.transform = transform
        self.backend = backend or 'numpy'
        n = _SPLIT_N[mode]
        rng = np.random.RandomState(401 + list(_SPLIT_N).index(mode))
        self.images = rng.randint(0, 256, size=(n, 64, 64, 3),
                                  dtype=np.uint8)
        # blocky masks: each quadrant gets one class id
        self.labels = np.zeros((n, 64, 64), dtype=np.int64)
        quads = rng.randint(0, self.NUM_CLASSES, size=(n, 2, 2))
        for i in range(n):
            for qy in range(2):
                for qx in range(2):
                    self.labels[i, qy * 32:(qy + 1) * 32,
                                qx * 32:(qx + 1) * 32] = quads[i, qy, qx]

    def __getitem__(self, idx):
        image, label = self.images[idx], self.labels[idx]
        if self.transform is not None:
            image = self.transform(image)
        return image, label

    def __len__(self):
        return len(self.images)
