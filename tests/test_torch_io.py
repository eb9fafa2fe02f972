"""The port's ``io`` against the JAX package's, on the CPU.

- every dataset, sampler and collate form gives the reference's items,
  indices and batches (seeded samplers with an int ``generator``; the
  unseeded ones are the reference's too and are checked for their
  shape only);
- ``pack_batch`` writes the reference's wire format byte for byte, and
  ``unpack_batch`` reads either package's;
- ``DataLoader``'s four paths (sync, threaded, the native ring, OS
  process workers) and ``device_prefetch`` give the reference's batches
  in the reference's order: the reference's host batches
  (``to_tensor=False``), each numeric array as a CPU tensor of its own
  dtype (the reference's JAX tensors narrow int64 to int32, as JAX
  does without x64; a torch loss takes int64 labels);
- a failing ``__getitem__``, a failing ``worker_init_fn`` and a worker
  process that dies raise in the consumer as in the reference.

Everything is held exactly: batches are host numpy in both packages.
"""
import os
import threading

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
from paddle_tpu.io import native as jnative
import paddle_tpu_torch as paddle
import paddle_tpu_torch.io as pio
from paddle_tpu_torch.io import native as pnative


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device('cpu')
    yield
    paddle.set_device(None)


def _host(x):
    """A batch of either package as nested numpy."""
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    if torch.is_tensor(x):
        return x.numpy()
    if hasattr(x, 'numpy') and not isinstance(x, np.ndarray):
        return np.asarray(x.numpy())
    return x


def _same(a, b):
    a, b = _host(a), _host(b)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, (a, b)
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


class Squares:
    """A map dataset defined once and built in both packages: (x, y)
    with x [3] f32 and y [1] int64, ``fail_at`` raising."""

    @staticmethod
    def make(io, n=10, fail_at=None):
        class DS(io.Dataset):
            def __len__(self):
                return n

            def __getitem__(self, i):
                if i == fail_at:
                    raise KeyError(f'bad sample {i}')
                x = np.arange(3, dtype=np.float32) + i
                return x, np.array([i * i], np.int64)
        return DS()


# -- datasets -----------------------------------------------------------
def test_tensor_compose_concat_subset_datasets():
    a = np.arange(12, dtype=np.float32).reshape(6, 2)
    b = np.arange(6, dtype=np.int64)
    for make in (lambda io: io.TensorDataset([a, b]),
                 lambda io: io.ComposeDataset([io.TensorDataset([a]),
                                               io.TensorDataset([b, a])]),
                 lambda io: io.ConcatDataset([io.TensorDataset([a, b]),
                                              Squares.make(io, 4)]),
                 lambda io: io.Subset(io.TensorDataset([a, b]), [5, 0, 3])):
        j, p = make(jio), make(pio)
        assert len(p) == len(j)
        for i in list(range(len(j))) + [-1]:
            _same(list(p[i]), list(j[i]))
    with pytest.raises(ValueError):
        pio.TensorDataset([a, b[:3]])


def test_iterable_and_chain_datasets():
    def make(io):
        class It(io.IterableDataset):
            def __init__(self, lo, hi):
                self.lo, self.hi = lo, hi

            def __iter__(self):
                return iter(np.arange(self.lo, self.hi, dtype=np.int64))
        return It
    J, P = make(jio), make(pio)
    # list() would ask for a length, which an iterable dataset refuses
    _same([x for x in pio.ChainDataset([P(0, 3), P(7, 9)])],
          [x for x in jio.ChainDataset([J(0, 3), J(7, 9)])])
    with pytest.raises(RuntimeError):
        len(P(0, 1))
    for kw in (dict(batch_size=2), dict(batch_size=2, drop_last=True),
               dict(batch_size=None)):
        _same(list(pio.DataLoader(P(0, 5), **kw)),
              list(jio.DataLoader(J(0, 5), to_tensor=False, **kw)))


@pytest.mark.parametrize('gen', [0, 7])
def test_random_split_with_an_int_generator(gen):
    j = jio.random_split(Squares.make(jio, 10), [3, 7], generator=gen)
    p = pio.random_split(Squares.make(pio, 10), [3, 7], generator=gen)
    for js, ps in zip(j, p):
        assert ps.indices == js.indices
    with pytest.raises(ValueError):
        pio.random_split(Squares.make(pio, 10), [3, 3])


# -- samplers ------------------------------------------------------------
def test_samplers_give_the_references_indices():
    ds_j, ds_p = Squares.make(jio, 11), Squares.make(pio, 11)
    assert list(pio.SequenceSampler(ds_p)) == list(jio.SequenceSampler(ds_j))
    for kw in (dict(generator=3), dict(generator=3, replacement=True),
               dict(generator=5, num_samples=4)):
        j, p = jio.RandomSampler(ds_j, **kw), pio.RandomSampler(ds_p, **kw)
        assert list(p) == list(j) and len(p) == len(j)
    unseeded = list(pio.RandomSampler(ds_p))
    assert sorted(unseeded) == list(range(11))
    np.random.seed(4)
    want = list(jio.WeightedRandomSampler([.1, .5, .2, .2], 9))
    np.random.seed(4)
    assert list(pio.WeightedRandomSampler([.1, .5, .2, .2], 9)) == want
    for kw in (dict(batch_size=3), dict(batch_size=3, drop_last=True),
               dict(batch_size=4, shuffle=True)):
        j, p = jio.BatchSampler(ds_j, **kw), pio.BatchSampler(ds_p, **kw)
        assert len(p) == len(j)
        if not kw.get('shuffle'):
            assert list(p) == list(j)
    sampler_j = jio.RandomSampler(ds_j, generator=1)
    sampler_p = pio.RandomSampler(ds_p, generator=1)
    assert list(pio.BatchSampler(sampler=sampler_p, batch_size=4)) == \
        list(jio.BatchSampler(sampler=sampler_j, batch_size=4))


@pytest.mark.parametrize('shuffle', [False, True])
@pytest.mark.parametrize('drop_last', [False, True])
def test_distributed_batch_sampler_shards_as_the_reference(shuffle,
                                                           drop_last):
    for rank in range(3):
        kw = dict(batch_size=2, num_replicas=3, rank=rank, shuffle=shuffle,
                  drop_last=drop_last)
        j = jio.DistributedBatchSampler(Squares.make(jio, 11), **kw)
        p = pio.DistributedBatchSampler(Squares.make(pio, 11), **kw)
        for epoch in (0, 1):
            j.set_epoch(epoch)
            p.set_epoch(epoch)
            assert list(p) == list(j) and len(p) == len(j)
    p = pio.DistributedBatchSampler(Squares.make(pio, 5), batch_size=2)
    assert (p.nranks, p.local_rank) == (1, 0)


# -- collate -------------------------------------------------------------
COLLATE = [
    [np.arange(3, dtype=np.float32), np.ones(3, np.float32)],
    [1, 2, 3], [1.5, 2.5], [np.int64(4), np.int64(5)], ['a', 'b'],
    [{'x': np.zeros(2, np.float32), 'y': 1},
     {'x': np.ones(2, np.float32), 'y': 2}],
    [(np.zeros(2, np.int32), (3, 'u')), (np.ones(2, np.int32), (4, 'v'))],
    [object, object],
]


@pytest.mark.parametrize('case', range(len(COLLATE)))
def test_default_collate_fn_forms(case):
    batch = COLLATE[case]
    _same(pio.default_collate_fn(batch), jio.default_collate_fn(batch))


def test_collate_of_tensors_stacks_host_numpy():
    got = pio.default_collate_fn([torch.ones(2), torch.zeros(2)])
    assert isinstance(got, np.ndarray) and got.shape == (2, 2)


# -- the wire format ------------------------------------------------------
WIRE = [
    [np.arange(12, dtype=np.float32).reshape(3, 4),
     np.arange(3, dtype=np.int64)[:, None], np.array(True)],
    [np.zeros((2, 0), np.uint8), np.arange(5, dtype=np.float16)],
    {'x': np.ones(2)}, ['a', np.ones(2)],
]


@pytest.mark.parametrize('case', range(len(WIRE)))
def test_pack_batch_is_the_references_wire_format(case):
    b = WIRE[case]
    raw = pnative.pack_batch(b)
    assert raw[0] == jnative.pack_batch(b)[0]
    if raw[0] == 0:
        assert raw == jnative.pack_batch(b)
    _same(pnative.unpack_batch(jnative.pack_batch(b)), b)
    _same(jnative.unpack_batch(raw), b)


def test_pack_error_crosses_the_ring():
    class Odd(Exception):
        def __init__(self, a, b):
            super().__init__(a)
    e = pnative.unpack_batch(pnative.pack_error(KeyError('k')))
    assert isinstance(e, KeyError)
    e = pnative.unpack_batch(pnative.pack_error(Odd(1, 2)))
    assert isinstance(e, RuntimeError) and 'Odd' in str(e)


def test_native_ring_builds_outside_the_source_tree():
    """g++ is here: the ring builds into the gitignored build tree, and
    no library lands beside the source."""
    from paddle_tpu_torch.io.native import buildlib
    assert pnative.available()
    so = buildlib.library_path(pnative._SRC, 'ringbuf', ('-pthread',))
    assert os.path.exists(so)
    assert os.sep + os.path.join('build', 'paddle_tpu_torch', 'native') \
        in so
    here = os.path.dirname(pnative._SRC)
    assert not [f for f in os.listdir(here) if f.endswith('.so')]


def test_native_ring_keeps_order_and_counts_what_it_carries():
    ring = pnative.NativeRing(2)
    n0 = pnative.batches_carried()
    payloads = [pnative.pack_batch([np.full(3, i, np.int32)])
                for i in range(5)]
    t = threading.Thread(target=lambda: [ring.push(i, payloads[i])
                                         for i in (1, 0, 3, 2, 4)])
    t.start()
    got = [int(pnative.unpack_batch(ring.pop())[0][0]) for _ in range(5)]
    t.join()
    assert got == list(range(5)) and pnative.batches_carried() - n0 == 5
    ring.close()
    assert ring.pop() is None


# -- DataLoader paths -------------------------------------------------------
# process workers fork a parent that runs JAX's threads: a ``timeout``
# turns a stalled child into a failure instead of a hung test run
PATHS = [dict(num_workers=0), dict(num_workers=2, use_native_loader=False),
         dict(num_workers=2),
         dict(num_workers=2, use_process_workers=True, timeout=60),
         dict(num_workers=2, use_process_workers=True,
              use_native_loader=False, timeout=60),
         dict(num_workers=2, device_prefetch=True),
         dict(num_workers=2, use_process_workers=True, device_prefetch=True,
              timeout=60)]


def _ids(kw):
    return '-'.join(f'{k}={v}' for k, v in kw.items())


@pytest.fixture(scope='module')
def reference_batches():
    dl = jio.DataLoader(Squares.make(jio, 13), batch_size=4,
                        to_tensor=False)
    return [_host(b) for b in dl]


@pytest.mark.parametrize('kw', PATHS, ids=_ids)
def test_every_path_gives_the_references_batches_in_order(kw,
                                                          reference_batches):
    dl = pio.DataLoader(Squares.make(pio, 13), batch_size=4, **kw)
    got = list(dl)
    assert len(got) == len(dl) == len(reference_batches)
    for g, w in zip(got, reference_batches):
        assert all(torch.is_tensor(t) and t.device.type == 'cpu' for t in g)
        _same(g, w)


def test_native_path_goes_through_the_ring():
    n0 = pnative.batches_carried()
    dl = pio.DataLoader(Squares.make(pio, 13), batch_size=4, num_workers=2)
    assert len(list(dl)) == 4
    assert pnative.batches_carried() - n0 == 4
    dl = pio.DataLoader(Squares.make(pio, 13), batch_size=4, num_workers=2,
                        use_process_workers=True, timeout=60)
    assert len(list(dl)) == 4
    assert pnative.batches_carried() - n0 == 8


def test_to_tensor_false_batch_size_none_and_a_sampler():
    kw = dict(batch_size=3, to_tensor=False, shuffle=False)
    _same(list(pio.DataLoader(Squares.make(pio, 7), **kw)),
          list(jio.DataLoader(Squares.make(jio, 7), **kw)))
    assert isinstance(next(iter(pio.DataLoader(Squares.make(pio, 7),
                                               **kw)))[0], np.ndarray)
    _same(list(pio.DataLoader(Squares.make(pio, 3), batch_size=None)),
          list(jio.DataLoader(Squares.make(jio, 3), batch_size=None,
                              to_tensor=False)))
    bs_p = pio.BatchSampler(sampler=pio.RandomSampler(Squares.make(pio, 9),
                                                      generator=2),
                            batch_size=4)
    bs_j = jio.BatchSampler(sampler=jio.RandomSampler(Squares.make(jio, 9),
                                                      generator=2),
                            batch_size=4)
    _same(list(pio.DataLoader(Squares.make(pio, 9), batch_sampler=bs_p,
                              num_workers=2)),
          list(jio.DataLoader(Squares.make(jio, 9), batch_sampler=bs_j,
                              num_workers=2, to_tensor=False)))


def test_worker_info_in_each_worker():
    def make(io):
        class Info(io.Dataset):
            def __len__(self):
                return 6

            def __getitem__(self, i):
                info = io.get_worker_info()
                return np.array([info.num_workers if info else -1])
        return Info()
    assert pio.get_worker_info() is None
    for kw in (dict(num_workers=0), dict(num_workers=2),
               dict(num_workers=2, use_process_workers=True, timeout=60)):
        _same(list(pio.DataLoader(make(pio), batch_size=2, **kw)),
              list(jio.DataLoader(make(jio), batch_size=2, to_tensor=False,
                                  **kw)))


# -- errors and deaths -----------------------------------------------------
@pytest.mark.parametrize('kw', PATHS, ids=_ids)
def test_a_failing_sample_raises_its_error_in_the_consumer(kw):
    dl = pio.DataLoader(Squares.make(pio, 13, fail_at=6), batch_size=4, **kw)
    it = iter(dl)
    assert len(_host(next(it))[0]) == 4
    with pytest.raises(KeyError, match='bad sample 6'):
        list(it)
    jdl = jio.DataLoader(Squares.make(jio, 13, fail_at=6), batch_size=4,
                         **{k: v for k, v in kw.items()
                            if k != 'device_prefetch'})
    with pytest.raises(KeyError, match='bad sample 6'):
        list(jdl)


@pytest.mark.parametrize('kw', PATHS[1:5], ids=_ids)
def test_a_failing_worker_init_fn_raises(kw):
    def init(wid):
        raise ValueError(f'init {wid}')
    with pytest.raises(ValueError, match='init'):
        list(pio.DataLoader(Squares.make(pio, 8), batch_size=2,
                            worker_init_fn=init, **kw))
    with pytest.raises(ValueError, match='init'):
        list(jio.DataLoader(Squares.make(jio, 8), batch_size=2,
                            worker_init_fn=init, **kw))


def _dying(io):
    class Dies(io.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                os._exit(0)        # a worker gone mid-task
            return np.array([i])
    return Dies()


@pytest.mark.parametrize('native', [True, False])
def test_a_dead_process_worker_raises_as_the_reference(native):
    kw = dict(batch_size=2, num_workers=2, use_process_workers=True,
              use_native_loader=native, timeout=1)
    with pytest.raises(RuntimeError, match='died|timed out'):
        list(pio.DataLoader(_dying(pio), **kw))
    with pytest.raises(RuntimeError, match='died|timed out'):
        list(jio.DataLoader(_dying(jio), **kw))


def test_process_workers_without_workers_warn_and_run_inline():
    with pytest.warns(UserWarning, match='no effect'):
        dl = pio.DataLoader(Squares.make(pio, 4), batch_size=2,
                            use_process_workers=True)
    assert len(list(dl)) == 2
    with pytest.warns(UserWarning, match='device_prefetch'):
        dl = pio.DataLoader(Squares.make(pio, 4), batch_size=2,
                            device_prefetch=True)
    assert dl.device_prefetch is False


def test_an_abandoned_epoch_leaves_no_worker_behind():
    before = {t.ident for t in threading.enumerate()}
    for kw in PATHS[1:]:
        it = iter(pio.DataLoader(Squares.make(pio, 40), batch_size=2, **kw))
        next(it)
        del it
    import gc
    import time
    gc.collect()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        extra = [t for t in threading.enumerate()
                 if t.ident not in before and t.is_alive()]
        if not extra:
            break
        time.sleep(0.1)
    assert not extra, extra


def test_device_prefetch_without_a_card_raises(monkeypatch):
    """No card and no ``set_device('cpu')``: staging has nowhere to go,
    and the loader raises instead of staging on the CPU."""
    paddle.set_device(None)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    dl = pio.DataLoader(Squares.make(pio, 4), batch_size=2, num_workers=1,
                        device_prefetch=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        list(dl)
