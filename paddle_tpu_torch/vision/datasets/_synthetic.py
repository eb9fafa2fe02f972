"""Deterministic synthetic data (counterpart of
``paddle_tpu/vision/datasets/_synthetic.py``: the same seeds give the
same images).

Paddle's datasets (python/paddle/vision/datasets/*) download their
files; the port, like the reference, never downloads: every dataset
parses files already on disk, or falls back to a deterministic
synthetic sample set when no local file is given.
Samples are class-separable (per-class template + bounded noise) so the
e2e convergence tests in SURVEY.md §4 are meaningful.
"""
import numpy as np


def synthetic_images(n, hwc, num_classes, seed):
    """Return (images uint8 [n,H,W,C], labels int64 [n])."""
    rng = np.random.RandomState(seed)
    h, w, c = hwc
    templates = rng.randint(0, 256, size=(num_classes, h, w, c))
    labels = rng.randint(0, num_classes, size=n).astype(np.int64)
    noise = rng.randint(-20, 21, size=(n, h, w, c))
    images = np.clip(templates[labels] + noise, 0, 255).astype(np.uint8)
    return images, labels
