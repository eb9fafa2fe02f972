"""DatasetFolder / ImageFolder.

Reference analogue: python/paddle/vision/datasets/folder.py:65
(DatasetFolder), :222 (ImageFolder).  Images load via numpy (`.npy`) or a
minimal PPM/PGM reader; other formats fall back to PIL if present.
"""
import os

import numpy as np

from ...io import Dataset

__all__ = ['DatasetFolder', 'ImageFolder']

IMG_EXTENSIONS = ('.jpg', '.jpeg', '.png', '.ppm', '.pgm', '.bmp', '.npy',
                  '.tif', '.tiff', '.webp')


def has_valid_extension(filename, extensions):
    return filename.lower().endswith(tuple(extensions))


def _read_pnm(path):
    with open(path, 'rb') as f:
        magic = f.readline().strip()
        if magic not in (b'P5', b'P6'):
            raise ValueError('unsupported PNM type: {}'.format(magic))
        vals = []
        while len(vals) < 3:
            line = f.readline()
            if line.startswith(b'#'):
                continue
            vals += line.split()
        w, h, _maxval = (int(v) for v in vals[:3])
        c = 3 if magic == b'P6' else 1
        data = np.frombuffer(f.read(w * h * c), dtype=np.uint8)
    return data.reshape(h, w, c)


def default_loader(path):
    """numpy for .npy, builtin reader for PPM/PGM, PIL for the rest."""
    if path.endswith('.npy'):
        return np.load(path)
    if path.lower().endswith(('.ppm', '.pgm')):
        return _read_pnm(path)
    try:
        from PIL import Image
        with Image.open(path) as img:
            return np.asarray(img.convert('RGB'))
    except ImportError as e:
        raise RuntimeError(
            'loading {} needs PIL, which is unavailable; use .npy or '
            'PPM/PGM images, or pass a custom loader'.format(path)) from e


def make_dataset(directory, class_to_idx, extensions=None,
                 is_valid_file=None):
    samples = []
    for target in sorted(class_to_idx):
        d = os.path.join(directory, target)
        if not os.path.isdir(d):
            continue
        for root, _, fnames in sorted(os.walk(d, followlinks=True)):
            for fname in sorted(fnames):
                path = os.path.join(root, fname)
                ok = is_valid_file(path) if is_valid_file is not None \
                    else has_valid_extension(path, extensions)
                if ok:
                    samples.append((path, class_to_idx[target]))
    return samples


class DatasetFolder(Dataset):
    """root/class_x/xxx.ext layout -> (sample, class_index)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or default_loader
        if extensions is None and is_valid_file is None:
            extensions = IMG_EXTENSIONS
        self.extensions = extensions
        classes, class_to_idx = self._find_classes(root)
        samples = make_dataset(root, class_to_idx, extensions,
                               is_valid_file)
        if not samples:
            raise RuntimeError(
                'found 0 files in subfolders of: {}'.format(root))
        self.classes = classes
        self.class_to_idx = class_to_idx
        self.samples = samples
        self.targets = [s[1] for s in samples]

    @staticmethod
    def _find_classes(directory):
        classes = sorted(e.name for e in os.scandir(directory)
                         if e.is_dir())
        return classes, {c: i for i, c in enumerate(classes)}

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Flat (or nested) folder of images -> [sample] (no labels)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or default_loader
        if extensions is None and is_valid_file is None:
            extensions = IMG_EXTENSIONS
        samples = []
        for r, _, fnames in sorted(os.walk(root, followlinks=True)):
            for fname in sorted(fnames):
                path = os.path.join(r, fname)
                ok = is_valid_file(path) if is_valid_file is not None \
                    else has_valid_extension(path, extensions)
                if ok:
                    samples.append(path)
        if not samples:
            raise RuntimeError('found 0 files in: {}'.format(root))
        self.samples = samples

    def __getitem__(self, idx):
        sample = self.loader(self.samples[idx])
        if self.transform is not None:
            sample = self.transform(sample)
        return [sample]

    def __len__(self):
        return len(self.samples)
