"""The fluid-era data stack of the port (slice 17): ``reader``'s
decorators, ``batch`` and the six ``dataset`` modules (``common``,
``image``, ``mnist``, ``cifar``, ``flowers``, ``voc2012``), each held to
the JAX package's on the same inputs: equal samples, in the same order
where the reference promises one (``shuffle`` under the same Python
``random`` seed, ``xmap_readers(order=True)``), as sets where it does
not (unordered ``xmap_readers``, ``multiprocess_reader``).  The datasets
come from the synthetic fallback of both packages' ``vision.datasets``
(no file is on disk and nothing is downloaded); their samples are equal
exactly.
"""
import itertools
import random

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as paddle
from paddle_tpu import dataset as jdataset
from paddle_tpu import reader as jreader
from paddle_tpu_torch import dataset, reader

PACKAGES = [(jreader, jpaddle.batch), (reader, paddle.batch)]


def _source(n=20):
    def r():
        for i in range(n):
            yield i, float(i) * 0.5
    return r


def _both(make):
    """``make(reader_module, batch)`` run on both packages, with
    Python's and numpy's generators at the same seed before each."""
    out = []
    for mod, batch in PACKAGES:
        random.seed(4)
        np.random.seed(4)
        out.append(list(make(mod, batch)()))
    return out


CASES = {
    'map_readers': lambda R, b: R.map_readers(lambda a, c: (a[0] + c[0],),
                                              _source(), _source(7)),
    'shuffle': lambda R, b: R.shuffle(_source(50), 16),
    'chain': lambda R, b: R.chain(_source(3), _source(4)),
    'compose': lambda R, b: R.compose(_source(5), _source(5)),
    'compose_unaligned': lambda R, b: R.compose(_source(5), _source(3),
                                                check_alignment=False),
    'buffered': lambda R, b: R.buffered(_source(30), 4),
    'firstn': lambda R, b: R.firstn(_source(), 6),
    'cache': lambda R, b: R.cache(_source(8)),
    'xmap_ordered': lambda R, b: R.xmap_readers(
        lambda s: (s[0] * 3, s[1]), _source(40), 4, 8, order=True),
    'batch': lambda R, b: b(_source(10), 4),
    'batch_drop_last': lambda R, b: b(_source(10), 4, drop_last=True),
    'shuffle_then_batch': lambda R, b: b(R.shuffle(_source(33), 10), 8),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_decorators_give_the_references_samples(name):
    want, got = _both(CASES[name])
    assert got == want and got


def test_unordered_readers_give_the_references_samples_as_sets():
    for make in (lambda R: R.xmap_readers(lambda s: s[0] * 2, _source(40),
                                          3, 4),
                 lambda R: R.multiprocess_reader([_source(10),
                                                  _source(5)])):
        want, got = (sorted(make(R)()) for R in (jreader, reader))
        assert got == want and len(got) in (40, 15)


def test_error_paths_match_the_references():
    for R, batch in PACKAGES:
        with pytest.raises(R.ComposeNotAligned):
            list(R.compose(_source(5), _source(3))())
        with pytest.raises(ValueError, match='batch_size'):
            batch(_source(), 0)

        def bad():
            yield 1
            raise RuntimeError('source failed')
        with pytest.raises(RuntimeError, match='source failed'):
            list(R.buffered(bad, 2)())
        with pytest.raises(RuntimeError, match='source failed'):
            list(R.xmap_readers(lambda s: s, bad, 2, 2)())
        with pytest.raises(ValueError):
            R.multiprocess_reader([])


def _first(make, n=4):
    return [list(itertools.islice(make(d)(), n))
            for d in (jdataset, dataset)]


def _equal_samples(want, got):
    assert len(got) == len(want) and got
    for w, g in zip(want, got):
        assert len(g) == len(w)
        for a, b in zip(w, g):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(b, a)


DATASETS = {
    'mnist.train': lambda d: d.mnist.train(),
    'mnist.test': lambda d: d.mnist.test(),
    'cifar.train10': lambda d: d.cifar.train10(),
    'cifar.test10': lambda d: d.cifar.test10(),
    'cifar.train100': lambda d: d.cifar.train100(),
    'cifar.test100': lambda d: d.cifar.test100(),
    'flowers.train': lambda d: d.flowers.train(),
    'flowers.test': lambda d: d.flowers.test(),
    'flowers.valid': lambda d: d.flowers.valid(),
    'voc2012.train': lambda d: d.voc2012.train(),
    'voc2012.test': lambda d: d.voc2012.test(),
    'voc2012.val': lambda d: d.voc2012.val(),
}


@pytest.mark.parametrize('name', sorted(DATASETS))
def test_datasets_give_the_references_samples(name):
    _equal_samples(*_first(DATASETS[name]))


def test_mnist_through_shuffle_and_batch_as_the_reference():
    want, got = [], []
    for out, (R, b), d in zip((want, got), PACKAGES, (jdataset, dataset)):
        random.seed(2)
        out.extend(itertools.islice(b(R.shuffle(d.mnist.test(), 64),
                                      16)(), 3))
    assert len(got) == 3
    for w, g in zip(want, got):
        _equal_samples(w, g)


def test_image_helpers_match_the_references():
    from paddle_tpu.dataset import image as jimage
    from paddle_tpu_torch.dataset import image
    im = np.random.RandomState(0).randint(0, 256, (40, 52, 3)) \
        .astype(np.uint8)
    calls = [
        lambda m: m.resize_short(im, 24),
        lambda m: m.to_chw(im),
        lambda m: m.center_crop(im, 20),
        lambda m: m.left_right_flip(im),
        lambda m: m.simple_transform(im, 32, 24, False,
                                     mean=[100.0, 110.0, 120.0]),
        lambda m: m.random_crop(im, 16),
        lambda m: m.simple_transform(im, 32, 24, True),
    ]
    for call in calls:
        np.random.seed(6)
        want = call(jimage)
        np.random.seed(6)
        got = call(image)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_common_split_and_cluster_files_reader(tmp_path):
    from paddle_tpu.dataset import common as jcommon
    from paddle_tpu_torch.dataset import common
    got = {}
    for name, mod in (('jax', jcommon), ('port', common)):
        d = tmp_path / name
        d.mkdir()
        mod.split(_source(23), 5, suffix=str(d / '%05d.pickle'))
        got[name] = [sorted(p.name for p in d.iterdir())] + [
            list(mod.cluster_files_reader(str(d / '*.pickle'), 2, t)())
            for t in (0, 1)]
        with pytest.raises(RuntimeError, match='cannot download'):
            mod.download('https://example.invalid/x.tgz', 'nope', None)
        with pytest.raises(ValueError):
            mod.split(_source(3), 2, suffix='no-format')
        assert mod.md5file(str(d / '00000.pickle'))
    assert got['port'] == got['jax']
