"""paddle_tpu_torch.io — datasets, samplers, DataLoader (counterpart of
``paddle_tpu/io``; Paddle's python/paddle/io).

The loader is a host-side prefetch pipeline, as in the reference: the
batch sampler's index lists are fetched and collated into numpy batches
by the consumer (``_iter_sync``), by worker threads that re-order in
Python (``_iter_threaded``) or through the native in-order ring
(``_iter_native``, ``io.native``), or by OS-process workers
(``_iter_process``, ``use_process_workers=True``, for transforms that
hold the GIL).  Threads are the default, as in the reference: numpy
transforms release the GIL.  Process workers start with ``fork`` where
the platform has it; a forked child produces numpy only and never
touches CUDA (the parent may already hold a CUDA context), and
``spawn``/``forkserver`` (``mp_context=``) re-import ``torch`` in each
child, about 2-3 s each.

The loader yields host tensors: each numeric numpy array of a batch
becomes a CPU ``torch.Tensor`` over the same memory (``to_tensor=False``
keeps numpy).  The consumer puts them where its model is (``hapi.Model``
stages them through pinned memory).  ``device_prefetch=True`` stages
them on the card ahead of the consumer instead: a thread copies each
batch from pinned host memory onto the device with ``non_blocking`` on a
side CUDA stream and records an event; the consumer's stream waits on
that event before the batch is used, and ``record_stream`` keeps each
staged tensor's memory from being reused while the consumer's stream
still reads it.  The dequeue wait is the overlap gauge, under the
reference's telemetry names (``io.device_prefetch.wait_s``,
``io.device_prefetch.last_wait_ms``; ``io.dataloader.*`` for every
path).  The staging device is the default device (``set_device``): the
card unless the caller asks for the CPU.
"""
import bisect
import itertools
import queue
import threading
import time

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ['Dataset', 'IterableDataset', 'TensorDataset', 'ChainDataset',
           'ComposeDataset', 'Subset', 'random_split', 'ConcatDataset',
           'Sampler', 'SequenceSampler', 'RandomSampler', 'BatchSampler',
           'WeightedRandomSampler', 'DistributedBatchSampler', 'DataLoader',
           'default_collate_fn', 'get_worker_info']


# -- datasets ----------------------------------------------------------------

class Dataset:
    """Map-style dataset (reference: io/dataset.py)."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        lens = {len(t) if isinstance(t, (list, np.ndarray)) else t.shape[0]
                for t in tensors}
        if len(lens) > 1:
            raise ValueError("tensors must share dim 0")
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        t = self.tensors[0]
        return len(t) if isinstance(t, (list, np.ndarray)) else t.shape[0]


class ComposeDataset(Dataset):
    """Zip several map datasets into one (fields concatenated)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    """Chain iterable datasets back-to-back."""

    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        return itertools.chain(*self.datasets)


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = list(
            itertools.accumulate(len(d) for d in self.datasets))

    def __len__(self):
        return self.cumulative_sizes[-1] if self.cumulative_sizes else 0

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = self.cumulative_sizes[ds - 1] if ds > 0 else 0
        return self.datasets[ds][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    if sum(lengths) != len(dataset):
        raise ValueError("sum of lengths must equal dataset length")
    rng = np.random.RandomState(generator if isinstance(generator, int)
                                else None)
    perm = rng.permutation(len(dataset))
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off:off + n].tolist()))
        off += n
    return out


# -- samplers ----------------------------------------------------------------

class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = np.random.RandomState(
            self.generator if isinstance(self.generator, int) else None)
        if self.replacement:
            return iter(rng.randint(0, n, size=self.num_samples).tolist())
        return iter(rng.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        super().__init__(None)
        self.weights = np.asarray(weights, dtype='float64')
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(p), size=self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        super().__init__(dataset)
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards sample indices across data-parallel ranks.

    Reference: io/dataloader/batch_sampler.py::DistributedBatchSampler.
    ``num_replicas`` and ``rank`` default to the global mesh's ``dp``
    size and this rank's ``dp`` coordinate (``fleet.init``), else to
    ``torch.distributed``'s world when a process group is up, else one
    rank.
    """

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        world, me = _world()
        self.nranks = num_replicas if num_replicas is not None else world
        self.local_rank = rank if rank is not None else me
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n)
        indices = np.concatenate(
            [indices, indices[:self.total_size - n]])  # pad to even shards
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


def _world():
    """(size, rank) of the data-parallel axis: the global mesh's ``dp``,
    else the ``torch.distributed`` group, (1, 0) without one."""
    from ..distributed import env as _env
    mesh = _env.get_mesh()
    if mesh is not None and 'dp' in mesh.shape:
        return mesh.axis_size('dp'), mesh.coords['dp']
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


# -- collate / worker info ---------------------------------------------------

def default_collate_fn(batch):
    """Stack a list of samples into batched numpy arrays (they stay on
    the host; the consumer puts each batch on its device once)."""
    sample = batch[0]
    if isinstance(sample, (np.ndarray, np.generic)):
        return np.stack(batch)
    if isinstance(sample, torch.Tensor):
        return np.stack([s.detach().cpu().numpy() for s in batch])
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return np.asarray(batch)
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        return [default_collate_fn(list(field)) for field in zip(*batch)]
    return list(batch)


class _WorkerInfo:
    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = threading.local()


def get_worker_info():
    return getattr(_worker_info, 'info', None)


def _process_worker(dataset, collate_fn, worker_init_fn, wid,
                    num_workers, task_q, result_q):
    """Process-worker loop (module-level so forkserver/spawn contexts
    can pickle it).  Tasks are (seq, indices); results are (seq,
    packed-payload bytes) — the same wire format the native ring
    carries, so the parent can feed either consumer path."""
    from . import native as _native
    _worker_info.info = _WorkerInfo(wid, num_workers, dataset)
    init_err = None
    try:
        if worker_init_fn is not None:
            worker_init_fn(wid)
    except Exception as e:     # fail every claimed batch, don't hang
        init_err = _native.pack_error(e)
    while True:
        task = task_q.get()
        if task is None:
            # explicit done-handshake: the parent can then tell a
            # cleanly-finished worker from one that exited mid-task
            result_q.put(('__done__', wid))
            return
        seq, indices = task
        if init_err is not None:
            result_q.put((seq, init_err))
            continue
        try:
            payload = _native.pack_batch(
                collate_fn([dataset[i] for i in indices]))
        except Exception as e:
            payload = _native.pack_error(e)
        result_q.put((seq, payload))


# -- DataLoader --------------------------------------------------------------

class _EndOfEpoch:
    pass


class DataLoader:
    """Prefetching loader (reference: io/dataloader/dataloader_iter.py).

    num_workers>0 → a thread pool maps __getitem__+collate concurrently
    and a bounded ring-buffer queue holds ready batches; the main thread
    dequeues host batches as CPU tensors, or as device tensors staged
    ahead with ``device_prefetch`` (on the default device)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=False, timeout=0, worker_init_fn=None,
                 persistent_workers=False, to_tensor=True,
                 use_native_loader=True, use_process_workers=False,
                 mp_context=None, device_prefetch=False):
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = max(0, int(num_workers))
        self.prefetch_factor = max(2, int(prefetch_factor))
        self.worker_init_fn = worker_init_fn
        self.to_tensor = to_tensor
        # opt-in OS-process workers for PIL/Python-heavy transforms
        # that hold the GIL (threads serialize there; the reference
        # forks workers for the same reason — dataloader_iter.py).
        # Requires picklable dataset/collate_fn/worker_init_fn.
        self.use_process_workers = bool(use_process_workers)
        self.mp_context = mp_context
        self.timeout = float(timeout) if timeout else 0.0
        if self.use_process_workers and (
                self.num_workers == 0
                or isinstance(dataset, IterableDataset)):
            import warnings
            warnings.warn(
                'use_process_workers=True has no effect with '
                'num_workers=0 or an IterableDataset — loading runs '
                'in the main process; set num_workers>0 on a '
                'map-style dataset to fork workers')
        # device_prefetch: double-buffered host->device staging — a
        # background thread copies the NEXT batch onto the device on a
        # side stream while the train loop executes the current one,
        # so the H2D copy overlaps compute (the fused K-step loop
        # stages whole chunks the same way — core.scan_loop.
        # ChunkPrefetcher).  Off for num_workers=0: there is no
        # producer thread to overlap with, and the extra queue hop
        # would only add latency.
        self.device_prefetch = bool(device_prefetch)
        if self.device_prefetch and self.num_workers == 0:
            import warnings
            warnings.warn(
                'device_prefetch=True has no effect with '
                'num_workers=0 — batches are produced on the consumer '
                'thread, so there is nothing to overlap; set '
                'num_workers>0 to enable background device staging')
            self.device_prefetch = False
        # native ring serializes batches: arrays travel zero-pickle, but
        # exotic batch objects must be picklable — set False to keep the
        # in-process threaded path for those
        self.use_native_loader = use_native_loader
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            if batch_size is None:
                self.batch_sampler = None
                self.batch_size = None
            else:
                self.batch_sampler = BatchSampler(
                    dataset, shuffle=shuffle, batch_size=batch_size,
                    drop_last=drop_last)

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def _fetch(self, indices):
        batch = [self.dataset[i] for i in indices]
        return self.collate_fn(batch)

    def _wrap(self, host_batch):
        """Numeric numpy leaves -> CPU tensors over the same memory."""
        if not self.to_tensor:
            return host_batch
        def dev(x):
            if isinstance(x, np.ndarray) and x.dtype != object and \
                    x.dtype.kind in 'biufc':
                if not x.flags.writeable:
                    x = x.copy()
                return torch.from_numpy(x)
            return x
        if isinstance(host_batch, dict):
            return {k: dev(v) for k, v in host_batch.items()}
        if isinstance(host_batch, (tuple, list)):
            return [dev(v) for v in host_batch]
        return dev(host_batch)

    # -- iteration paths -----------------------------------------------------
    def _iter_sync(self):
        if self._iterable:
            it = iter(self.dataset)
            if self.batch_size is None:
                for item in it:
                    yield self._wrap(item)
                return
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and self.drop_last:
                    return
                yield self._wrap(self.collate_fn(batch))
        elif self.batch_sampler is None:
            # batch_size=None → yield raw samples, no collation
            for i in range(len(self.dataset)):
                yield self._wrap(self.dataset[i])
        else:
            for indices in self.batch_sampler:
                yield self._wrap(self._fetch(indices))

    def _iter_threaded(self):
        out_q = queue.Queue(maxsize=self.num_workers * self.prefetch_factor)
        work_q = queue.Queue()
        for pos, indices in enumerate(self.batch_sampler):
            work_q.put((pos, indices))
        n_batches = work_q.qsize()
        results = {}
        stop = threading.Event()

        def put(item):
            # bounded put that gives up once the consumer abandons the
            # generator — a worker parked forever on a full out_q is an
            # orphan daemon thread
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker(wid):
            try:
                _worker_info.info = _WorkerInfo(wid, self.num_workers,
                                                self.dataset)
                if self.worker_init_fn is not None:
                    self.worker_init_fn(wid)
            except Exception as e:
                # deliver the failure for every batch this worker would
                # have claimed, so the main thread raises instead of
                # deadlocking on out_q.get()
                while True:
                    try:
                        pos, _ = work_q.get_nowait()
                    except queue.Empty:
                        return
                    if not put((pos, e)):
                        return
            while not stop.is_set():
                try:
                    pos, indices = work_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    item = self._fetch(indices)
                except Exception as e:  # surface in main thread
                    item = e
                if not put((pos, item)):
                    return

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            # re-order: batches may finish out of order; emit sequentially
            next_pos = 0
            received = 0
            while next_pos < n_batches:
                if next_pos in results:
                    item = results.pop(next_pos)
                else:
                    pos, item = out_q.get()
                    received += 1
                    if pos != next_pos:
                        results[pos] = item
                        continue
                if isinstance(item, Exception):
                    raise item
                yield self._wrap(item)
                next_pos += 1
        finally:
            stop.set()
            # workers poll `stop` on every queue op, so they exit
            # within one 0.1s tick; the timeout only guards a
            # __getitem__ wedged mid-fetch
            for t in threads:
                t.join(timeout=2.0)

    def _iter_native(self):
        """Workers pack collated batches into the C++ in-order ring
        (paddle_tpu.io.native); the ring enforces sequencing and
        backpressure in native code — no Python-side reorder dict.
        Payloads come back as contiguous 64B-aligned buffers, which
        torch.from_numpy wraps without re-gathering."""
        from . import native as _native
        indices_list = list(self.batch_sampler)
        n_batches = len(indices_list)
        ring = _native.NativeRing(self.num_workers * self.prefetch_factor)
        next_seq = [0]
        seq_lock = threading.Lock()

        def worker(wid):
            try:
                _worker_info.info = _WorkerInfo(wid, self.num_workers,
                                                self.dataset)
                if self.worker_init_fn is not None:
                    self.worker_init_fn(wid)
            except Exception as e:
                payload = _native.pack_error(e)
                while True:
                    with seq_lock:
                        if next_seq[0] >= n_batches:
                            return
                        seq = next_seq[0]
                        next_seq[0] += 1
                    if not ring.push(seq, payload):
                        return
            while True:
                with seq_lock:
                    if next_seq[0] >= n_batches:
                        return
                    seq = next_seq[0]
                    next_seq[0] += 1
                try:
                    payload = _native.pack_batch(
                        self._fetch(indices_list[seq]))
                except Exception as e:
                    payload = _native.pack_error(e)
                try:
                    if not ring.push(seq, payload):
                        return
                except Exception:
                    # a claimed-but-unfilled seq would hang the consumer
                    # forever; closing the ring surfaces the failure
                    ring.close()
                    raise
        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            yield from self._consume_ring(ring, n_batches)
        finally:
            # close() makes every blocked ring.push return False, so
            # the workers fall out of their claim loops — then a
            # bounded join reaps them (no orphan daemon threads)
            ring.close()
            for t in threads:
                t.join(timeout=2.0)

    def _consume_ring(self, ring, n_batches, pending_error=None):
        """Shared consumer side of the in-order native ring: pop,
        unpack, surface worker exceptions, wrap.  `pending_error` is a
        one-slot list a producer thread fills before closing the ring
        early (a silent short epoch would corrupt training)."""
        from . import native as _native
        for i in range(n_batches):
            payload = ring.pop()
            if payload is None:
                if pending_error:
                    raise pending_error[0]
                raise RuntimeError(
                    f'native loader ring closed after {i}/'
                    f'{n_batches} batches (worker failure)')
            item = _native.unpack_batch(payload)
            if isinstance(item, Exception):
                raise item
            yield self._wrap(item)

    def _iter_process(self):
        """Opt-in OS-process workers (`use_process_workers=True`):
        child processes run __getitem__ + collate in parallel — the
        escape hatch for PIL/Python-heavy transforms where threads
        serialize on the GIL (reference
        io/dataloader/dataloader_iter.py forks workers for the same
        reason).  Start method: `fork` where the
        platform has it (like the reference — no main-module guard
        needed, closures allowed, no per-child re-import; safe because
        children run the dataset and collate only, on numpy, and never
        touch CUDA even where the parent holds a context), else
        forkserver/spawn, which require picklable dataset/collate_fn
        and an `if __name__ == '__main__'` guard in user scripts —
        override via `mp_context=`.  Children return packed payloads
        (the native ring wire format) over a bounded mp queue; the
        parent re-sequences and, when the C++ ring is built, feeds it
        so the consumer side is the same aligned zero-copy pop as the
        threaded native path.  Workers live per-epoch
        (persistent_workers is accepted but not persisted)."""
        import multiprocessing as mp
        if self.mp_context:
            ctx = mp.get_context(self.mp_context)
        else:
            methods = mp.get_all_start_methods()
            ctx = mp.get_context(
                'fork' if 'fork' in methods else
                'forkserver' if 'forkserver' in methods else 'spawn')
        from . import native as _native
        indices_list = list(self.batch_sampler)
        n_batches = len(indices_list)
        window = max(2, self.num_workers * self.prefetch_factor)
        task_q = ctx.Queue()
        result_q = ctx.Queue(maxsize=window)
        # windowed dispatch anchored at the CONSUMER cursor: only seqs
        # < want + window are ever dispatched, so one straggler worker
        # cannot make the parent stash more than `window` payloads
        # (dispatching per-result instead would bound dispatched-minus-
        # received but let the stash grow to the whole epoch)
        state = {'next_task': 0, 'received': 0, 'sentinels': False}

        def dispatch_upto(want):
            while state['next_task'] < min(n_batches, want + window):
                seq = state['next_task']
                task_q.put((seq, list(indices_list[seq])))
                state['next_task'] = seq + 1
            if state['next_task'] == n_batches \
                    and not state['sentinels']:
                for _ in range(self.num_workers):
                    task_q.put(None)
                state['sentinels'] = True

        dispatch_upto(0)
        procs = [ctx.Process(
            target=_process_worker,
            args=(self.dataset, self.collate_fn, self.worker_init_fn,
                  w, self.num_workers, task_q, result_q), daemon=True)
            for w in range(self.num_workers)]
        try:
            for p in procs:
                p.start()
        except Exception as e:
            raise RuntimeError(
                'process workers could not start — under '
                f'{ctx.get_start_method()!r} the dataset/collate_fn/'
                'worker_init_fn must be picklable and user scripts '
                "need an `if __name__ == '__main__'` guard; use "
                'threads (use_process_workers=False) for closures, or '
                "mp_context='fork' where available") from e

        poll_s = self.timeout or 5.0
        stash = {}
        done_wids = set()

        def ordered_payloads():
            """Yield payloads in seq order; a dead child must raise,
            not hang the epoch.  A worker is 'dead' when its process
            exited without the done-handshake — exit code 0 from a
            dataset calling sys.exit(0) mid-task counts; a slow batch
            on a live worker does not."""
            import queue as _queue
            for want in range(n_batches):
                dispatch_upto(want)
                stalled_polls = 0
                while want not in stash:
                    try:
                        seq, payload = result_q.get(timeout=poll_s)
                    except _queue.Empty:
                        died = [(i, p.exitcode)
                                for i, p in enumerate(procs)
                                if p.exitcode is not None
                                and i not in done_wids]
                        if died:
                            raise RuntimeError(
                                f'process worker {died[0][0]} died '
                                f'(exitcode {died[0][1]}) after '
                                f"{state['received']}/{n_batches} "
                                'batches') from None
                        if self.timeout:
                            raise RuntimeError(
                                f'DataLoader timed out after '
                                f'{self.timeout}s waiting for batch '
                                f'{want}') from None
                        stalled_polls += 1
                        if stalled_polls % 12 == 0:   # ~once a minute
                            # children are alive but silent: a genuine
                            # slow sample, OR a fork-inherited-lock
                            # deadlock (forking a threaded parent)
                            # — surface the escape hatches instead of
                            # hanging mutely forever
                            import warnings
                            waited = stalled_polls * poll_s
                            warnings.warn(
                                f'DataLoader batch {want} has produced '
                                f'no data for {waited:.0f}s with '
                                'workers alive; if this is not a slow '
                                "sample, try mp_context='forkserver' "
                                '(fork can deadlock on locks inherited '
                                'from a threaded parent) or set '
                                'timeout= to fail fast')
                        continue
                    if seq == '__done__':
                        done_wids.add(payload)
                        continue
                    stash[seq] = payload
                    state['received'] += 1
                yield want, stash.pop(want)

        use_ring = self.use_native_loader and _native.available()
        try:
            if use_ring:
                ring = _native.NativeRing(window)
                drain_err = []

                def drain():
                    try:
                        for seq, payload in ordered_payloads():
                            if not ring.push(seq, payload):
                                return     # consumer closed the ring
                    except BaseException as e:
                        drain_err.append(e)
                        ring.close()

                t = threading.Thread(target=drain, daemon=True)
                t.start()
                try:
                    yield from self._consume_ring(ring, n_batches,
                                                  drain_err)
                finally:
                    # close() unblocks a drain parked on ring.push (it
                    # returns False), so the bounded join reaps it
                    ring.close()
                    t.join(timeout=2.0)
            else:
                for _, payload in ordered_payloads():
                    # bytearray copy: frombuffer over the queue's bytes
                    # would yield READ-ONLY arrays, unlike every other
                    # loader path
                    item = _native.unpack_batch(
                        np.frombuffer(bytearray(payload), np.uint8))
                    if isinstance(item, Exception):
                        raise item
                    yield self._wrap(item)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=2)

    @staticmethod
    def _device_put_batch(item, device):
        """Stage one (possibly wrapped) batch on ``device``: numeric
        numpy and tensor leaves go there through pinned host memory with
        ``non_blocking`` (on the current stream, the staging thread's
        side stream); other leaves pass through.  Returns the staged
        batch and its device tensors."""
        staged = []

        def dev(x):
            if isinstance(x, np.ndarray) and x.dtype != object and \
                    x.dtype.kind in 'biufc':
                x = torch.from_numpy(np.ascontiguousarray(x))
            if not isinstance(x, torch.Tensor):
                return x
            if x.device != device:
                if device.type == 'cuda' and x.device.type == 'cpu':
                    x = x.pin_memory().to(device, non_blocking=True)
                else:
                    x = x.to(device)
            staged.append(x)
            return x
        if isinstance(item, dict):
            return {k: dev(v) for k, v in item.items()}, staged
        if isinstance(item, (tuple, list)):
            return [dev(v) for v in item], staged
        return dev(item), staged

    def _iter_device_prefetch(self, inner):
        """Double-buffered device staging: a daemon thread pulls from
        the worker pipeline, copies each batch onto the device on a side
        CUDA stream and records an event there, and parks up to two
        staged batches in a bounded queue.  The consumer's stream waits
        on a batch's event before the batch is handed out, and each of
        its tensors is marked used on that stream (``record_stream``),
        so the allocator reuses its memory only after the consumer's
        work on it.  The dequeue wait is the OVERLAP gauge: ~0 ms means
        the transfer fully hid behind compute; a persistent positive
        value means the loader (or the H2D link) is the bottleneck."""
        from .. import telemetry
        device = resolve_device()
        cuda = device.type == 'cuda'
        side = torch.cuda.Stream(device) if cuda else None
        out_q = queue.Queue(maxsize=2)
        err = []
        closed = []             # consumer-gone flag (one-slot list)
        _SENTINEL = _EndOfEpoch

        def put(item):
            while not closed:
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for item in inner:
                    if cuda:
                        with torch.cuda.stream(side):
                            staged, tensors = self._device_put_batch(
                                item, device)
                            ready = torch.cuda.Event()
                            ready.record(side)
                    else:
                        (staged, tensors), ready = \
                            self._device_put_batch(item, device), None
                    if not put((staged, tensors, ready)):
                        return
            except BaseException as e:
                err.append(e)
            finally:
                put(_SENTINEL)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        _perf = time.perf_counter
        try:
            while True:
                t0 = _perf()
                item = out_q.get()
                dt = _perf() - t0
                telemetry.add('io.device_prefetch.wait_s', dt)
                telemetry.set_gauge('io.device_prefetch.last_wait_ms',
                                    round(dt * 1000.0, 4))
                if item is _SENTINEL:
                    if err:
                        raise err[0]
                    return
                staged, tensors, ready = item
                if ready is not None:
                    stream = torch.cuda.current_stream(device)
                    stream.wait_event(ready)
                    for x in tensors:
                        x.record_stream(stream)
                yield staged
        finally:
            # an abandoned iterator (early stop, preemption, raised
            # callback) must release the producer parked on the full
            # queue — otherwise each broken-off epoch leaks a thread
            # plus two device-staged batches for the process lifetime
            closed.append(True)
            try:
                while True:
                    out_q.get_nowait()
            except queue.Empty:
                pass
            # producer's put-poll re-checks `closed` every 0.1s; the
            # timeout only guards a copy wedged mid-transfer
            t.join(timeout=2.0)

    def _telemetry_iter(self, inner):
        """Time each dequeue — the HOST-WAIT gauge: how long the
        training loop blocked on this loader per batch (for the
        threaded/native paths that is queue-pop time, i.e. true
        starvation; for the sync path it is fetch+collate).  Pure
        perf_counter deltas on the host — never touches the device."""
        from .. import telemetry
        _perf = time.perf_counter
        while True:
            t0 = _perf()
            try:
                item = next(inner)
            except StopIteration:
                return
            dt = _perf() - t0
            telemetry.add('io.dataloader.wait_s', dt)
            telemetry.add('io.dataloader.batches', 1)
            telemetry.set_gauge('io.dataloader.last_wait_ms',
                                round(dt * 1000.0, 4))
            yield item

    def __iter__(self):
        if self.num_workers > 0 and not self._iterable \
                and self.batch_sampler is not None:
            if self.use_process_workers:
                it = self._iter_process()
            else:
                from . import native as _native
                if self.use_native_loader and _native.available():
                    it = self._iter_native()
                else:
                    it = self._iter_threaded()
        else:
            it = self._iter_sync()
        if self.device_prefetch and self.num_workers > 0 \
                and not self._iterable and self.batch_sampler is not None:
            it = self._iter_device_prefetch(it)
        from ..telemetry import active as _telemetry_active
        if _telemetry_active():
            return self._telemetry_iter(it)
        return it
