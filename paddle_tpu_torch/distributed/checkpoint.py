"""Async checkpointing with verified commits (counterpart of
``paddle_tpu/distributed/checkpoint.py``).

    save_sharded(tree, path, async_save=True)   -> wait() handle
    load_sharded(path, like=tree)               -> restored tree
    CheckpointManager(dir, keep)                -> step-level save/
                                                   restore/latest

A tree is a nested dict (or list, tuple) of torch tensors, numpy arrays
and Python scalars, such as ``ParallelTrainer.train_state()``.

**The layout of a step directory.**  The reference hands its JAX tree
to orbax, which writes tensorstore shards from device memory; orbax is
a JAX library, so the port keeps its own layout, which needs nothing
beyond the standard library, numpy and torch:

- ``_TREE_INDEX.json``: every leaf's path (``leaf_spec``'s key),
  shape, dtype, kind (tensor, numpy or Python scalar) and payload file;
- one payload file per leaf, ``<leaf path>.bin``: the leaf's bytes,
  C order, little-endian.  A bf16 leaf (numpy cannot hold bf16
  without ``ml_dtypes``) is stored as its 16-bit pattern, with
  ``storage: int16`` beside ``dtype: bfloat16`` in the index;
- the reference's commit manifest (``resilience.manifest``), key for
  key, so the reference's ``verify_manifest`` and
  ``tools/check_ckpt.py`` read these directories.

**An async save** must not race the trainer, whose step updates
parameters and moments in place (the reference's arrays are
immutable).  So ``save_sharded`` first stages every leaf: a card leaf
is copied into pinned host memory on a side stream that waits for the
current stream, and the handle's ``fence`` event marks that copy's end
(``ParallelTrainer`` makes its next step's stream wait on it, a device
wait, no host sync); a CPU leaf is cloned.  Only then does a writer
thread wait for the copy, put the bytes on disk through
``resilience.manifest.atomic_write`` (the seam chaos's file faults
patch) under ``resilience.retry``, and take each file's size and
sha256 from the bytes it wrote (hashed by a small thread pool beside
the writes, which stay in the tree's order); ``wait()`` joins it and
commits the manifest with those records.  A payload torn under the writer then
fails verification instead of being certified at its torn size.  The
writer blocks in the CUDA runtime, in file writes and in hashing, all of
which release the interpreter lock; it never polls.

Crash safety is the reference's: a save only counts once its manifest
lands, ``latest_step()`` is the latest committed step, a committed
directory that fails verification is quarantined and restore walks
back to the previous committed step, and multi-host saves commit in two
phases (``save_sharded(two_phase=True)``, ``save_host_shard``).

Not ported: ``compile_cache.warm_start`` (the reference pre-loads
exported XLA executables beside a run directory before a restore); a
CUDA graph cannot be serialised, so a restored trainer captures its
graphs anew at its first chunk.  Checkpoints at a world above 1 and
restoring onto another mesh wait for ROADMAP Queue 1 item 9b's second
part (the trainer refuses them there): the manifest
records the saving ``process_count`` and a restore into another logs
``reshape_restore``, as the reference does.
"""
import concurrent.futures
import hashlib
import json
import os
import shutil
import threading
import time
import warnings

import numpy as np
import torch

from ..resilience import manifest as _manifest
from ..resilience.retry import retry as _retry

__all__ = ['save_sharded', 'load_sharded', 'CheckpointManager',
           'save_host_shard', 'load_host_shard',
           'latest_committed_step', 'INDEX_NAME']

INDEX_NAME = '_TREE_INDEX.json'
_INDEX_FORMAT = 1
_ALGO = 'sha256'
_HASH_THREADS = 4

# dtypes numpy cannot hold everywhere: stored as their bit pattern
_BITS = {torch.bfloat16: torch.int16}


def _process():
    """(rank, world size) of this process in ``torch.distributed``."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _flat(tree):
    return [('/'.join(str(k) for k in path), v)
            for path, v in _manifest._leaves(tree)]


def _rebuild(like, values, path=()):
    """``like``'s structure with each leaf replaced by ``values[key]``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, values, path + (k,)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_rebuild(v, values, path + (i,)) for i, v in enumerate(like)]
        return type(like)(out)
    return values['/'.join(str(k) for k in path)]


class _Staging:
    """Pinned host buffers reused across a manager's saves (one save is
    in flight at a time, so the next may overwrite them)."""

    def __init__(self):
        self._bufs = {}

    def get(self, key, like):
        buf = self._bufs.get(key)
        if buf is None or buf.shape != like.shape or buf.dtype != like.dtype:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._bufs[key] = buf
        return buf

    @property
    def nbytes(self):
        return sum(b.numel() * b.element_size() for b in self._bufs.values())


def _stage(tree, staging=None):
    """Host copies of every leaf: ``(leaves, start, fence)``, where
    ``leaves`` is ``[(key, kind, host value, type name)]`` and ``start``
    and ``fence`` the (timing) events recorded before and after the card
    leaves' copies (None without card leaves).  The copies run on a side
    stream that first waits for the current stream, so they read the
    state the queued work leaves."""
    leaves, cuda = [], []
    for key, v in _flat(tree):
        if torch.is_tensor(v):
            v = v.detach()
            if v.is_cuda:
                cuda.append((key, v))
                leaves.append([key, 'tensor', None, None])
            else:
                leaves.append([key, 'tensor', v.clone(), None])
        elif isinstance(v, np.ndarray) or isinstance(v, np.generic):
            leaves.append([key, 'numpy', np.array(v, copy=True), None])
        elif isinstance(v, (bool, int, float)):
            leaves.append([key, 'scalar', np.asarray(v), type(v).__name__])
        else:
            raise TypeError(f'checkpoint leaf {key!r}: unsupported type '
                            f'{type(v).__name__}')
    start = fence = None
    if cuda:
        device = cuda[0][1].device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        host = {}
        start = torch.cuda.Event(enable_timing=True)
        start.record(side)
        with torch.cuda.stream(side):
            for key, v in cuda:
                buf = (staging.get(key, v) if staging is not None else
                       torch.empty(v.shape, dtype=v.dtype, pin_memory=True))
                buf.copy_(v, non_blocking=True)
                v.record_stream(side)
                host[key] = buf
        fence = torch.cuda.Event(enable_timing=True)
        fence.record(side)
        for leaf in leaves:
            if leaf[0] in host:
                leaf[2] = host[leaf[0]]
    return leaves, start, fence


def _leaf_bytes(kind, value):
    """(numpy view of the payload, dtype name, storage name or None)."""
    if kind != 'tensor':
        return np.ascontiguousarray(value), str(value.dtype), None
    dtype = str(value.dtype)[len('torch.'):]
    if value.dtype in _BITS:
        store = _BITS[value.dtype]
        return (value.contiguous().view(store).numpy(), dtype,
                str(store)[len('torch.'):])
    return value.contiguous().numpy(), dtype, None


def _write_leaves(path, step, leaves, fence, checksums):
    """The writer: wait for the staging copies, write every payload and
    the index through ``manifest.atomic_write``, and return the
    manifest records of the files written.  The digests are taken by a
    small pool of threads beside the writes (hashing releases the
    interpreter lock); the writes themselves go one by one, in the
    tree's order, so a seeded chaos plan sees the same sequence of
    files every run."""
    if fence is not None:
        fence.synchronize()
    payloads, index = [], {}
    for key, kind, value, pytype in leaves:
        arr, dtype, storage = _leaf_bytes(kind, value)
        rel = key + '.bin'
        payloads.append((rel, memoryview(np.ascontiguousarray(arr).reshape(
            -1).view(np.uint8)).cast('B')))
        entry = {'file': rel, 'kind': kind, 'dtype': dtype,
                 'shape': [int(d) for d in arr.shape]}
        if storage is not None:
            entry['storage'] = storage
        if pytype is not None:
            entry['type'] = pytype
        index[key] = entry
    doc = json.dumps({'format': _INDEX_FORMAT, 'step': step,
                      'leaves': index}, indent=1, sort_keys=True)
    payloads.append((INDEX_NAME, memoryview(doc.encode('utf-8'))))

    def digest(data):
        return hashlib.sha256(data).hexdigest()

    with concurrent.futures.ThreadPoolExecutor(_HASH_THREADS) as pool:
        digests = [pool.submit(digest, data) if checksums else None
                   for _, data in payloads]
        for rel, data in payloads:
            p = os.path.join(path, rel)
            os.makedirs(os.path.dirname(p), exist_ok=True)
            _retry(lambda: _manifest.atomic_write(
                p, lambda f: f.write(data), mode='wb', prefix='.leaf_tmp'),
                retries=2, backoff=0.05)()
        records = {}
        for (rel, data), fut in zip(payloads, digests):
            records[rel] = {'size': data.nbytes}
            if fut is not None:
                records[rel][_ALGO] = fut.result()
    return records


class _SaveHandle:
    """Completion handle for one save.  ``wait()`` is idempotent: the
    first successful call drains the writer and commits the manifest;
    later calls are no-ops.  A ``wait()`` that RAISES may be retried:
    each sub-step (drain, commit) runs at most once, so a transient
    commit failure is retryable without writing the payloads twice.
    ``fence`` is the event after the staging copies (None when the tree
    held no card tensor); ``dispatch_s`` the caller's time in
    ``save_sharded``, ``write_s`` the writer's, ``drain_s`` the time
    ``wait()`` blocked on it and ``copy_ms()`` the device time of the
    staging copies."""

    def __init__(self, writer, on_commit=None, step=None, path=None,
                 fence=None, dispatch_s=None, start=None):
        self._writer = writer
        self._on_commit = on_commit
        self._drained = False
        self._done = False
        self._step = step
        self.path = path
        self.fence = fence
        self._start = start
        self.dispatch_s = dispatch_s
        self.drain_s = None
        self.records = None

    @property
    def write_s(self):
        return self._writer.seconds

    def copy_ms(self):
        """Device milliseconds of the staging copies (None without card
        leaves); waits for them."""
        if self.fence is None:
            return None
        self.fence.synchronize()
        return self._start.elapsed_time(self.fence)

    def _drain(self):
        """Join the writer; re-raises its error."""
        t0 = time.perf_counter()
        self.records = self._writer.result()
        self.drain_s = time.perf_counter() - t0

    def wait(self):
        if self._done:
            return
        t0 = time.perf_counter()
        if not self._drained:
            self._drain()
            self._drained = True
        if self._on_commit is not None:
            self._on_commit(self.records)
        self._done = True
        from ..telemetry import event as _tevent
        _tevent('checkpoint_commit', step=self._step,
                dur_s=round(time.perf_counter() - t0, 6))

    @property
    def committed(self):
        return self._done


class _Writer:
    """The payload writer: a thread (async) or the caller (sync)."""

    def __init__(self, fn, threaded):
        self._fn = fn
        self._result = self._error = None
        self.seconds = None
        self._thread = None
        if threaded:
            self._thread = threading.Thread(target=self._run,
                                            name='checkpoint-writer',
                                            daemon=True)
            self._thread.start()
        else:
            self._run()

    def _run(self):
        t0 = time.perf_counter()
        try:
            self._result = self._fn()
        except BaseException as e:      # handed to wait()
            self._error = e
        self.seconds = time.perf_counter() - t0

    def result(self):
        if self._thread is not None:
            self._thread.join()
        if self._error is not None:
            raise self._error
        return self._result


def save_sharded(tree, path, async_save=True, overwrite=True,
                 commit=True, step=None, checksums=True,
                 two_phase=None, num_hosts=None, barrier_timeout=120.0,
                 staging=None):
    """Write a tree under `path` in the layout above.  Returns a
    handle; call .wait() before relying on the files (async mode
    overlaps the writes with compute until then).  With `commit`
    (default) wait() also writes the commit manifest that marks the
    directory as a finished, verifiable checkpoint.  `checksums=False`
    records sizes only.

    Multi-host runs commit in TWO PHASES (resilience.manifest): every
    process's wait() writes an intent/ack and process 0 writes the
    final manifest only after every host's ack arrived (bounded by
    `barrier_timeout`).  `two_phase` defaults to a world size above
    1; tests force it with an explicit `num_hosts` to simulate a pod in
    one process.  `staging` (a manager's pinned buffers) is reused
    across saves."""
    from ..telemetry import event as _tevent
    path = os.path.abspath(path)
    proc, nprocs = _process()
    if two_phase is None:
        two_phase = nprocs > 1
    hosts = int(num_hosts) if num_hosts is not None else nprocs
    t0 = time.perf_counter()
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(f'checkpoint {path} exists')
        shutil.rmtree(path)
    os.makedirs(path)
    spec = _manifest.leaf_spec(tree)
    leaves, start, fence = _stage(tree, staging)
    writer = _Writer(lambda: _write_leaves(path, step, leaves, fence,
                                           checksums),
                     threaded=async_save)
    # async mode: dispatch_s is the synchronous cost the step loop
    # paid; the writes overlap later compute and their drain is timed
    # by the checkpoint_commit event in _SaveHandle.wait()
    dispatch_s = time.perf_counter() - t0
    _tevent('checkpoint_save', step=step, path=path,
            async_save=bool(async_save), dispatch_s=round(dispatch_s, 6))
    on_commit = None
    if commit:
        meta = {'process_count': nprocs}
        if two_phase:
            def on_commit(records):
                # phase 1: THIS host's payloads are durable.  Phase 2
                # runs on process 0 only.
                _manifest.write_intent(path, proc, step=step,
                                       files=sorted(records),
                                       checksums=checksums)
                if proc == 0:
                    _manifest.finalize_two_phase(
                        path, hosts, step=step, tree=None,
                        checksums=checksums, meta=dict(meta, leaf_spec=spec),
                        timeout=barrier_timeout)
        elif proc == 0:
            def on_commit(records):
                _manifest.write_manifest(
                    path, step=step, checksums=checksums,
                    meta=dict(meta, leaf_spec=spec), records=records)
    handle = _SaveHandle(writer, on_commit=on_commit, step=step,
                         path=path, fence=fence, dispatch_s=dispatch_s,
                         start=start)
    if not async_save:
        handle.wait()
    return handle


def _read_leaf(path, entry):
    """One payload as a CPU tensor (kind 'tensor') or numpy array."""
    storage = entry.get('storage')
    raw = np.fromfile(os.path.join(path, entry['file']), dtype=np.uint8)
    shape = tuple(entry['shape'])
    if entry['kind'] != 'tensor':
        return raw.view(np.dtype(entry['dtype'])).reshape(shape)
    if storage is not None:
        bits = torch.from_numpy(raw.view(np.dtype(storage)))
        return bits.view(getattr(torch, entry['dtype'])).reshape(shape)
    return torch.from_numpy(raw.view(np.dtype(entry['dtype'])).reshape(
        shape))


def load_sharded(path, like, device=None):
    """Restore a tree saved by save_sharded.  `like` supplies the
    structure; a tensor leaf comes back on `device`, or on its `like`
    leaf's device when None; numpy leaves as numpy, Python scalars as
    their type."""
    path = os.path.abspath(path)
    with open(os.path.join(path, INDEX_NAME)) as f:
        index = json.load(f)['leaves']
    values = {}
    for key, ref in _flat(like):
        entry = index.get(key)
        if entry is None:
            raise KeyError(f'{key!r} is not in checkpoint {path}')
        v = _read_leaf(path, entry)
        if torch.is_tensor(ref):
            v = v.to(ref.device if device is None else device)
        elif entry['kind'] == 'scalar':
            v = {'bool': bool, 'int': int, 'float': float}.get(
                entry.get('type'), lambda x: x)(v.item())
        elif torch.is_tensor(v):
            raise TypeError(f'{key!r} is a tensor in {path}, numpy in '
                            'the template')
        values[key] = v
    return _rebuild(like, values)


def _host_array(v):
    if torch.is_tensor(v):
        if v.dtype in _BITS:
            raise TypeError('save_host_shard: numpy cannot hold '
                            f'{v.dtype}; cast first')
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_host_shard(run_dir, step, host, arrays, num_hosts,
                    prefix='step', finalize=None, checksums=True,
                    barrier_timeout=120.0, meta=None):
    """Per-HOST shard save with the cross-host two-phase commit — the
    multi-process checkpoint path for host-local state.

    Each host writes ``<run_dir>/<prefix>_<step>/shard_r<host>.npz``
    (the reference's file) through resilience.manifest.atomic_write
    (the chaos file seam covers it), then acks with a phase-1 intent.
    Host 0 (`finalize` overrides) finalizes the two-phase commit once
    every host's ack landed, recording ``process_count`` so
    ``check_ckpt --deep --cluster`` can audit the rank set.  Raises
    CommitBarrierTimeout from the finalizer when an ack never arrives.

    Returns the manifest doc on the finalizing host, else None."""
    import io
    from ..telemetry import event as _tevent
    host = int(host)
    num_hosts = int(num_hosts)
    if finalize is None:
        finalize = host == 0
    step_dir = os.path.join(os.path.abspath(run_dir), f'{prefix}_{step}')
    os.makedirs(step_dir, exist_ok=True)
    rel = f'shard_r{host}.npz'
    buf = io.BytesIO()
    np.savez(buf, **{k: _host_array(v) for k, v in arrays.items()})
    payload = buf.getvalue()
    t0 = time.perf_counter()
    _manifest.atomic_write(os.path.join(step_dir, rel),
                           lambda f: f.write(payload), mode='wb',
                           prefix='.shard_tmp')
    _tevent('checkpoint_save', step=step, path=step_dir,
            async_save=False, host=host,
            dispatch_s=round(time.perf_counter() - t0, 6))
    _manifest.write_intent(step_dir, host, step=step, files=[rel],
                           checksums=checksums)
    if not finalize:
        return None
    full_meta = {'process_count': num_hosts}
    full_meta.update(meta or {})
    doc = _manifest.finalize_two_phase(
        step_dir, num_hosts, step=step, checksums=checksums,
        meta=full_meta, timeout=barrier_timeout)
    _tevent('checkpoint_commit', step=step, host=host, dur_s=None)
    return doc


def load_host_shard(run_dir, step, host, prefix='step'):
    """This host's shard dict (numpy) from a COMMITTED per-host step
    dir, or None (absent / uncommitted / unreadable — the caller falls
    back to an older step or a cold start)."""
    step_dir = os.path.join(os.path.abspath(run_dir), f'{prefix}_{step}')
    if not _manifest.is_committed(step_dir):
        return None
    p = os.path.join(step_dir, f'shard_r{int(host)}.npz')
    try:
        with np.load(p) as z:
            return {k: z[k].copy() for k in z.files}
    except (OSError, ValueError):
        return None


def latest_committed_step(run_dir, prefix='step'):
    """Newest COMMITTED step id under `run_dir`, or -1."""
    best = -1
    try:
        names = os.listdir(os.path.abspath(run_dir))
    except OSError:
        return best
    for f in names:
        tag = f[len(prefix) + 1:]
        if not (f.startswith(prefix + '_') and tag.isdigit()):
            continue
        if _manifest.is_committed(os.path.join(run_dir, f)):
            best = max(best, int(tag))
    return best


class CheckpointManager:
    """Step-level checkpoint rotation — the recovery path.  save() is
    async by default: step N+1 computes while step N's payloads hit
    disk, staged through pinned buffers the manager keeps
    (``pinned_bytes``).

    Only COMMITTED steps (valid manifest) are visible to
    latest_step()/restore(); restore() further verifies the manifest's
    sizes/checksums and walks back to the previous committed step when
    a directory turns out torn, renaming the torn dir aside
    (quarantine) so it is preserved for forensics but never selected
    again."""

    def __init__(self, directory, keep=3, prefix='step', async_save=True,
                 verify=True, checksums=True, two_phase=None,
                 num_hosts=None, barrier_timeout=120.0,
                 half_commit_grace=300.0):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self.prefix = prefix
        self.async_save = async_save
        self.verify = verify
        self.checksums = checksums
        # cross-host two-phase commit knobs (see save_sharded); a dir
        # holding 2PC acks but no manifest for longer than
        # half_commit_grace seconds is a half-committed save whose
        # finalizer died between the phases — quarantineable
        self.two_phase = two_phase
        self.num_hosts = num_hosts
        self.barrier_timeout = barrier_timeout
        self.half_commit_grace = half_commit_grace
        self._pending = None
        self._pending_step = None
        self._staging = _Staging()
        os.makedirs(self.directory, exist_ok=True)

    @property
    def pinned_bytes(self):
        """Bytes of pinned host memory the staging buffers hold."""
        return self._staging.nbytes

    def _path(self, step):
        return os.path.join(self.directory, f'{self.prefix}_{step}')

    def _steps(self, committed=True):
        """Step ids present on disk, ascending.  committed=True (the
        default and the only safe reader view) filters to dirs whose
        commit manifest landed; committed=False additionally includes
        torn/in-flight dirs — writer-side bookkeeping only."""
        out = []
        for f in os.listdir(self.directory):
            tag = f[len(self.prefix) + 1:]
            if not (f.startswith(self.prefix + '_') and tag.isdigit()):
                continue
            if committed and not _manifest.is_committed(
                    self._path(int(tag))):
                continue
            out.append(int(tag))
        return sorted(out)

    def save(self, tree, step):
        self.wait()  # one in-flight save at a time
        handle = save_sharded(tree, self._path(step),
                              async_save=self.async_save, step=step,
                              checksums=self.checksums,
                              two_phase=self.two_phase,
                              num_hosts=self.num_hosts,
                              barrier_timeout=self.barrier_timeout,
                              staging=self._staging)
        if not self.async_save:
            self._prune()
            return handle
        self._pending = handle
        self._pending_step = step
        return handle

    def wait(self):
        if self._pending is not None:
            self._pending.wait()
            self._pending = None
            self._pending_step = None
            self._prune()

    def _prune(self):
        """Rotate out old COMMITTED checkpoints beyond `keep`.
        Uncommitted dirs are never pruned here: the newest may be an
        in-flight async save (ours or another process's), and torn
        ones are quarantined — not destroyed — by restore()."""
        for s in self._steps(committed=True)[:-self.keep]:
            shutil.rmtree(self._path(s), ignore_errors=True)

    def _quarantine(self, step):
        """Move a torn step dir aside (never delete: a human may want
        the payloads) under a non-step name so every lister skips it."""
        src = self._path(step)
        for k in range(100):
            dst = f'{src}.torn-{k}'
            if not os.path.exists(dst):
                try:
                    os.replace(src, dst)
                    from ..telemetry import event as _tevent
                    _tevent('checkpoint_quarantine', step=step,
                            path=src, moved_to=dst)
                    return dst
                except OSError:
                    break
        return None

    def latest_step(self):
        """Newest COMMITTED step, or -1."""
        steps = self._steps(committed=True)
        return steps[-1] if steps else -1

    def restore(self, like, step=None, verify=None, device=None):
        """Restore `step` (default: latest committed) into a tree
        shaped like `like` (tensor leaves on `device`, or on their
        `like` leaf's device).  Returns (tree, step) or (None, -1) when
        no committed checkpoint exists.

        Each candidate's manifest is verified (file presence + sizes +
        checksums) before a payload is read; a torn candidate is
        quarantined and the previous committed step is tried — restore
        degrades to older data, never crashes on (or silently loads)
        partial state."""
        verify = self.verify if verify is None else verify
        self._sweep_half_committed()
        if step is not None:
            candidates = [step] + [s for s in
                                   reversed(self._steps(committed=True))
                                   if s < step]
        else:
            candidates = list(reversed(self._steps(committed=True)))
        if not candidates:
            uncommitted = self._steps(committed=False)
            if uncommitted:
                warnings.warn(
                    f'{len(uncommitted)} step dir(s) under '
                    f'{self.directory} have no commit manifest '
                    '(torn, or written without one); none are '
                    'restorable as-is — inspect with check_ckpt and '
                    'adopt trusted dirs with --adopt', RuntimeWarning,
                    stacklevel=2)
        for s in candidates:
            path = self._path(s)
            if not os.path.isdir(path):
                if s == step:
                    warnings.warn(
                        f'requested checkpoint step {step} does not '
                        f'exist under {self.directory}; falling back '
                        'to previous committed step',
                        RuntimeWarning, stacklevel=2)
                continue
            if s == self._pending_step:
                # our own async save is still in flight
                continue
            doc = _manifest.read_manifest(path)
            if doc is None:
                # no manifest: a kill-between-save-and-commit artifact
                # or ANOTHER process's in-flight save — never
                # quarantine, just skip
                warnings.warn(
                    f'checkpoint {path} has no commit manifest (torn '
                    'or in-flight); falling back to previous '
                    'committed step', RuntimeWarning, stacklevel=2)
                continue
            if verify:
                ok, errors = _manifest.verify_manifest(path)
                if not ok:
                    moved = self._quarantine(s)
                    warnings.warn(
                        f'checkpoint {path} failed verification '
                        f'({errors[:3]}{"..." if len(errors) > 3 else ""})'
                        + (f'; quarantined to {moved}' if moved else '')
                        + '; falling back to previous committed step',
                        RuntimeWarning, stacklevel=2)
                    continue
            if doc.get('leaf_spec'):
                # wrong-template restore is a CALLER bug: fail fast
                diffs = _manifest.spec_mismatches(
                    doc['leaf_spec'], _manifest.leaf_spec(like))
                if diffs:
                    raise ValueError(
                        f'restore template does not match checkpoint '
                        f'{path}: ' + '; '.join(diffs[:5])
                        + ('...' if len(diffs) > 5 else ''))
            self._note_reshape(doc, s)
            from ..telemetry import span as _tspan
            with _tspan('checkpoint_restore', step=s, path=path):
                tree = load_sharded(path, like, device=device)
            return tree, s
        return None, -1

    def _sweep_half_committed(self):
        """Quarantine UNCOMMITTED step dirs whose two-phase acks went
        stale: the finalizer died between intent and finalize, nobody
        is still writing.  Dirs with fresh acks or no acks at all are
        never touched."""
        committed = set(self._steps(committed=True))
        for s in self._steps(committed=False):
            if s in committed or s == self._pending_step:
                continue
            path = self._path(s)
            age = _manifest.intent_age(path)
            if age is None or age <= self.half_commit_grace:
                continue
            moved = self._quarantine(s)
            warnings.warn(
                f'checkpoint {path} is half-committed (2-phase acks '
                f'{age:.0f}s stale, no final manifest — finalizer '
                'died between intent and finalize)'
                + (f'; quarantined to {moved}' if moved else '')
                + '; falling back to previous committed step',
                RuntimeWarning, stacklevel=3)

    @staticmethod
    def _note_reshape(doc, step):
        """A restore into another process count than the save's lands
        in telemetry as ``reshape_restore``, as the reference's."""
        saved = doc.get('process_count')
        cur = _process()[1]
        if saved is not None and saved != cur:
            from ..telemetry import event as _tevent
            _tevent('reshape_restore', step=step,
                    saved_process_count=saved, process_count=cur)
