"""The port's ``vision.transforms`` and ``vision.datasets`` against the
JAX package's, on the CPU.

Every transform of both ``__all__`` lists runs on the same seeded
images (uint8 and float HWC, and 2-D grayscale) with ``random`` and
numpy reseeded to the same value before each call, and every synthetic
dataset split, the IDX (MNIST), pickle-tar (Cifar) and folder (PPM/PGM,
``.npy``) parsers run on the same files.  Everything is held bit for
bit: the transforms are host numpy in both packages.
"""
import gzip
import os
import pickle
import random
import struct
import tarfile

import numpy as np
import pytest

from paddle_tpu.vision import datasets as jds
from paddle_tpu.vision import transforms as jT
from paddle_tpu_torch.vision import datasets as pds
from paddle_tpu_torch.vision import transforms as pT


def _images():
    rs = np.random.RandomState(0)
    return {'u8': rs.randint(0, 256, (37, 29, 3)).astype(np.uint8),
            'f32': rs.rand(30, 41, 3).astype(np.float32),
            'gray': rs.randint(0, 256, (23, 31)).astype(np.uint8)}


def _same(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _seeded(fn, seed):
    random.seed(seed)
    np.random.seed(seed)
    return fn()


TRANSFORMS = [
    ('Resize', (16,), {}), ('Resize', ((20, 12),), {}),
    ('Resize', ((9, 50),), dict(interpolation='nearest')),
    ('RandomResizedCrop', (24,), {}),
    ('RandomResizedCrop', ((16, 20),), dict(scale=(0.5, 1.0))),
    ('CenterCrop', (15,), {}), ('CenterCrop', ((11, 7),), {}),
    ('RandomHorizontalFlip', (), dict(prob=1.0)),
    ('RandomHorizontalFlip', (), {}), ('RandomVerticalFlip', (), {}),
    ('Transpose', (), {}), ('Transpose', ((1, 0, 2),), {}),
    ('Normalize', (127.5, 127.5), dict(data_format='HWC')),
    ('Normalize', ([0.5, 0.4, 0.3], [0.2, 0.3, 0.4]),
     dict(data_format='HWC', to_rgb=True)),
    ('BrightnessTransform', (0.4,), {}), ('ContrastTransform', (0.4,), {}),
    ('SaturationTransform', (0.4,), {}), ('HueTransform', (0.2,), {}),
    ('ColorJitter', (0.3, 0.3, 0.3, 0.1), {}),
    ('RandomCrop', (12,), {}),
    ('RandomCrop', (40,), dict(pad_if_needed=True)),
    ('RandomCrop', (14,), dict(padding=3, fill=7)),
    ('Pad', (2,), {}), ('Pad', ((1, 2, 3, 4),), dict(fill=9)),
    ('Pad', (3,), dict(padding_mode='reflect')),
    ('Pad', ((2, 1),), dict(padding_mode='edge')),
    ('RandomRotation', (30,), {}),
    ('RandomRotation', ((-45, 45),), dict(interpolation='bilinear',
                                          expand=True)),
    ('Grayscale', (), {}), ('Grayscale', (3,), {}),
    ('ToTensor', (), {}), ('ToTensor', (), dict(data_format='HWC')),
]


def _outcome(fn):
    """(result, None) or (None, the exception's type)."""
    try:
        return fn(), None
    except Exception as e:      # the reference's refusal is the case
        return None, type(e)


@pytest.mark.parametrize('case', range(len(TRANSFORMS)),
                         ids=[f'{t[0]}-{i}' for i, t in enumerate(TRANSFORMS)])
@pytest.mark.parametrize('kind', ['u8', 'f32', 'gray'])
def test_transform_equals_the_reference(case, kind):
    """The same output, or (a color transform or a 3-channel
    normalisation of a 2-D image) the same refusal."""
    name, args, kw = TRANSFORMS[case]
    img = _images()[kind]
    if kind == 'gray' and name == 'Transpose' and not args:
        img = img[:, :, None]
    for seed in (0, 1, 2):
        want, jerr = _outcome(lambda: _seeded(
            lambda: getattr(jT, name)(*args, **kw)(img.copy()), seed))
        got, perr = _outcome(lambda: _seeded(
            lambda: getattr(pT, name)(*args, **kw)(img.copy()), seed))
        assert perr is jerr
        if jerr is None:
            _same(got, want)


FUNCTIONAL = [
    ('to_tensor', (), {}), ('resize', (17,), {}),
    ('resize', ((13, 40),), dict(interpolation='nearest')),
    ('crop', (2, 3, 10, 12), {}), ('center_crop', (9,), {}),
    ('hflip', (), {}), ('vflip', (), {}),
    ('pad', ((1, 2),), dict(fill=3)),
    ('pad', (2,), dict(padding_mode='symmetric')),
    ('rotate', (33,), {}), ('rotate', (-70,), dict(interpolation='bilinear')),
    ('rotate', (90,), dict(expand=True)),
    ('rotate', (15,), dict(center=(4, 6), fill=5)),
    ('to_grayscale', (), {}), ('to_grayscale', (3,), {}),
    ('normalize', ([100., 110., 120.], [50., 60., 70.]),
     dict(data_format='HWC')),
    ('adjust_brightness', (1.3,), {}), ('adjust_contrast', (0.6,), {}),
    ('adjust_saturation', (1.7,), {}), ('adjust_hue', (-0.2,), {}),
]


@pytest.mark.parametrize('case', range(len(FUNCTIONAL)),
                         ids=[f'{t[0]}-{i}' for i, t in enumerate(FUNCTIONAL)])
@pytest.mark.parametrize('kind', ['u8', 'f32'])
def test_functional_equals_the_reference(case, kind):
    name, args, kw = FUNCTIONAL[case]
    img = _images()[kind]
    want = getattr(jT.functional, name)(img.copy(), *args, **kw)
    got = getattr(pT.functional, name)(img.copy(), *args, **kw)
    _same(got, want)


def test_compose_of_the_tutorials_pipelines():
    img = _images()['u8']
    for make in (
            lambda T: T.Compose([T.Normalize(mean=[127.5], std=[127.5],
                                             data_format='HWC'),
                                 T.Transpose((2, 0, 1))]),
            lambda T: T.Compose([T.RandomResizedCrop(224),
                                 T.RandomHorizontalFlip(),
                                 T.Normalize(mean=[127.5] * 3,
                                             std=[127.5] * 3,
                                             data_format='HWC'),
                                 T.Transpose((2, 0, 1))])):
        for seed in range(4):
            want = _seeded(lambda: make(jT)(img), seed)
            got = _seeded(lambda: make(pT)(img), seed)
            _same(got, want)
    assert sorted(pT.__all__) == sorted(jT.__all__)


# -- datasets ------------------------------------------------------------
SPLITS = [('MNIST', 'train'), ('MNIST', 'test'), ('FashionMNIST', 'train'),
          ('Cifar10', 'train'), ('Cifar10', 'test'), ('Cifar100', 'test'),
          ('Flowers', 'train'), ('Flowers', 'valid'), ('Flowers', 'test'),
          ('VOC2012', 'train'), ('VOC2012', 'valid'), ('VOC2012', 'test')]


@pytest.mark.parametrize('name,mode', SPLITS)
def test_synthetic_split_equals_the_reference(name, mode):
    j, p = getattr(jds, name)(mode=mode), getattr(pds, name)(mode=mode)
    assert len(p) == len(j)
    n = len(j)
    for i in sorted({0, 1, n // 2, n - 1}):
        _same(p[i], j[i])


def test_dataset_transform_is_applied_as_the_reference():
    norm = dict(mean=[127.5], std=[127.5], data_format='HWC')
    j = jds.MNIST(mode='train', transform=jT.Normalize(**norm))
    p = pds.MNIST(mode='train', transform=pT.Normalize(**norm))
    for i in (0, 7, 8191):
        _same(p[i], j[i])


def _write_idx(path, arr, gz):
    arr = np.ascontiguousarray(arr, np.uint8)
    head = struct.pack('>I', 0x0800 | arr.ndim) + struct.pack(
        '>' + 'I' * arr.ndim, *arr.shape)
    opener = gzip.open if gz else open
    with opener(path, 'wb') as f:
        f.write(head + arr.tobytes())


@pytest.mark.parametrize('gz', [False, True])
def test_mnist_parses_idx_files_as_the_reference(tmp_path, gz):
    rs = np.random.RandomState(1)
    ext = '.gz' if gz else ''
    img, lab = str(tmp_path / f'img{ext}'), str(tmp_path / f'lab{ext}')
    _write_idx(img, rs.randint(0, 256, (5, 28, 28)), gz)
    _write_idx(lab, rs.randint(0, 10, (5,)), gz)
    j = jds.MNIST(image_path=img, label_path=lab)
    p = pds.MNIST(image_path=img, label_path=lab)
    assert len(p) == len(j) == 5
    for i in range(5):
        _same(p[i], j[i])


def test_cifar_parses_the_pickle_tar_as_the_reference(tmp_path):
    rs = np.random.RandomState(2)
    path = str(tmp_path / 'cifar.tar.gz')
    with tarfile.open(path, 'w:gz') as tf:
        for name, n in (('data_batch_1', 4), ('test_batch', 3)):
            doc = {b'data': rs.randint(0, 256, (n, 3072)).astype(np.uint8),
                   b'labels': list(rs.randint(0, 10, n))}
            raw = pickle.dumps(doc)
            f = tmp_path / name
            f.write_bytes(raw)
            tf.add(str(f), arcname=f'cifar-10-batches-py/{name}')
    for mode, n in (('train', 4), ('test', 3)):
        j = jds.Cifar10(data_file=path, mode=mode)
        p = pds.Cifar10(data_file=path, mode=mode)
        assert len(p) == len(j) == n
        for i in range(n):
            _same(p[i], j[i])


def _write_ppm(path, img):
    h, w = img.shape[:2]
    magic = b'P6' if img.ndim == 3 else b'P5'
    with open(path, 'wb') as f:
        f.write(magic + b'\n%d %d\n255\n' % (w, h) + img.tobytes())


def test_folders_parse_as_the_reference(tmp_path):
    rs = np.random.RandomState(3)
    for cls in ('cat', 'dog'):
        d = tmp_path / cls
        os.makedirs(d)
        for i in range(2):
            _write_ppm(str(d / f'{i}.ppm'),
                       rs.randint(0, 256, (6, 5, 3)).astype(np.uint8))
        np.save(str(d / 'x.npy'), rs.rand(4, 4, 3).astype(np.float32))
        _write_ppm(str(d / 'g.pgm'), rs.randint(0, 256, (3, 4)).astype(
            np.uint8))
    j, p = jds.DatasetFolder(str(tmp_path)), pds.DatasetFolder(str(tmp_path))
    assert p.classes == j.classes and p.class_to_idx == j.class_to_idx
    assert [os.path.relpath(s, tmp_path) for s, _ in p.samples] == \
        [os.path.relpath(s, tmp_path) for s, _ in j.samples]
    for i in range(len(j)):
        _same(p[i], j[i])
    ji, pi = jds.ImageFolder(str(tmp_path)), pds.ImageFolder(str(tmp_path))
    assert len(pi) == len(ji) == len(j)
    for i in range(len(ji)):
        _same(pi[i], ji[i])
    with pytest.raises(RuntimeError, match='found 0 files'):
        pds.DatasetFolder(str(tmp_path), extensions=('.none',))


def test_bad_modes_raise_as_the_reference():
    for name in ('MNIST', 'Cifar10', 'Flowers', 'VOC2012'):
        with pytest.raises(AssertionError):
            getattr(jds, name)(mode='nope')
        with pytest.raises(AssertionError):
            getattr(pds, name)(mode='nope')
    with pytest.raises(ValueError, match='backend'):
        pds.MNIST(backend='bogus')
