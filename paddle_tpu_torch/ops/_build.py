"""Builds the port's CUDA kernels with nvcc and binds them with ctypes.

Counterpart of ``paddle_tpu/ops/_gating.py``: where the JAX package
decides per call whether a Pallas kernel may run, the port decides by
the tensor alone (a CUDA tensor launches the kernel, a CPU tensor runs
the plain twin) and this module only builds and binds.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled at first use by
``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`` into ``build/paddle_tpu_torch/`` at the repository
root, under a name keyed by a hash of the source, every header under
``csrc/`` (``*.cuh``, which a source may include) and the flags, and
loaded with ``ctypes``.  ``build()`` starts one nvcc per source, all at
once, and waits for every one of them.  A failed build raises with
nvcc's stderr; there is no fallback.

Each ``Kernel`` counts its launches.  Under a CUDA-graph capture a
wrapper's launch is recorded, not run: ``capture_launches()`` takes
the capture's counts back out and keeps them, and the graph adds them
again on every replay (``CapturedLaunches.replayed``), so the counts
stay what the card ran.  A replay is counted under ``counts_lock``, so
a thread that reads under it sees the launches agree with the replays.
"""
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

__all__ = ['Kernel', 'KERNELS', 'aligned16', 'build', 'load', 'sources',
           'reset_launches', 'capture_launches', 'CapturedLaunches',
           'counts_lock', 'stream']

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), 'build',
                         'paddle_tpu_torch')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')

_lock = threading.Lock()
_libs = {}
counts_lock = threading.Lock()


def sources():
    """Names of the kernel sources under ``csrc/`` (without ``.cu``)."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith('.cu'))


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') \
        or '/usr/local/cuda'
    cand = os.path.join(home, 'bin', 'nvcc')
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        'nvcc not found (looked on PATH and in CUDA_HOME/bin): the '
        "port's CUDA kernels are built from csrc/ at first use")


def _target(name):
    """(source path, library path): the library's name carries a hash of
    the source, of every header under ``csrc/`` and of the flags, so an
    edit to any of them builds anew."""
    src = os.path.join(CSRC_DIR, name + '.cu')
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith('.cuh'))
    for path in [src] + [os.path.join(CSRC_DIR, h) for h in headers]:
        with open(path, 'rb') as f:
            digest.update(os.path.basename(path).encode() + b'\0'
                          + f.read())
    digest.update(' '.join(NVCC_FLAGS).encode())
    key = digest.hexdigest()[:16]
    return src, os.path.join(BUILD_DIR, f'{name}-{key}.so')


def _start(name):
    """Start nvcc for ``name`` unless its library is already built;
    returns (library path, running job or None)."""
    src, out = _target(name)
    if os.path.exists(out):
        return out, None
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    proc = subprocess.Popen([nvcc, *NVCC_FLAGS, '-o', tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return out, (proc, tmp)


def build(names=None):
    """Build the named sources (all of ``csrc/`` by default), one nvcc
    each, all started together; waits for every one and raises with
    the stderr of those that failed."""
    names = sources() if names is None else list(names)
    with _lock:
        jobs = [(name, *_start(name)) for name in names]
        errors = []
        for name, out, job in jobs:
            if job is None:
                continue
            proc, tmp = job
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f'nvcc failed on {name}.cu (exit '
                              f'{proc.returncode}):\n{err}')
                if os.path.exists(tmp):
                    os.remove(tmp)
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError('\n'.join(errors))
    return [_target(name)[1] for name in names]


def load(name):
    """The loaded ``ctypes`` library of ``csrc/<name>.cu``, built first
    if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path, = build([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(path)
            lib.ptt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.ptt_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


class Kernel:
    """One hand-written kernel: a C entry point in a ``csrc/`` library,
    the TPU kernel it replaces, and a count of its launches.

    ``launch(*args)`` calls the entry point (which queues the kernel on
    the stream it is given and returns ``cudaGetLastError()``), raises
    if that is not 0, and adds one to ``launches``.  Nothing else
    touches the count.

    Where one entry point holds more than one design and the wrapper
    picks one per launch (by dtype and shape, before the launch),
    ``variants`` names them: ``launch(*args, variant=v)`` then also adds
    one to ``variant_launches[v]``, so a run can show which design its
    launches took."""

    def __init__(self, name, source, symbol, argtypes, replaces,
                 route='cuda', variants=()):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.route = route
        self.launches = 0
        self.variant_launches = {v: 0 for v in variants}
        self._fn = None
        self._lib = None
        KERNELS.append(self)

    @property
    def source_path(self):
        return os.path.relpath(os.path.join(CSRC_DIR, self.source + '.cu'),
                               os.path.dirname(PKG_DIR))

    def _bind(self):
        lib = load(self.source)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._lib, self._fn = lib, fn
        return fn

    def launch(self, *args, variant=None):
        known = (variant in self.variant_launches if self.variant_launches
                 else variant is None)
        if not known:
            raise ValueError(f'{self.name}: variant {variant!r}, expected '
                             f'one of {tuple(self.variant_launches)}')
        fn = self._fn or self._bind()
        err = fn(*args)
        if err != 0:
            msg = self._lib.ptt_cuda_error_string(err).decode()
            raise RuntimeError(f'{self.name}: CUDA launch failed '
                               f'({err}: {msg})')
        self.launches += 1
        if variant is not None:
            self.variant_launches[variant] += 1


KERNELS = []


def stream(device):
    """The current CUDA stream of ``device``, as the int a launch
    takes."""
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return torch.cuda.current_stream().cuda_stream
    return torch.cuda.current_stream().cuda_stream


def aligned16(*tensors):
    """The tensors, each copied if its data does not start on 16 bytes
    (a view at an odd offset; a fresh allocation does): for kernels that
    move 16 bytes at a time or through TMA."""
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone()
                 for t in tensors)


def reset_launches():
    """Set every kernel's launch counts to 0."""
    for k in KERNELS:
        k.launches = 0
        for v in k.variant_launches:
            k.variant_launches[v] = 0


class CapturedLaunches:
    """The launches one CUDA-graph capture recorded, per kernel and per
    design: ``replayed(n)`` adds them ``n`` times, once per replay."""

    def __init__(self):
        self.delta = []         # [(kernel, launches, {design: launches})]

    def replayed(self, times=1):
        for k, n, variants in self.delta:
            k.launches += n * times
            for v, m in variants.items():
                k.variant_launches[v] += m * times

    def counts(self):
        """``{kernel name: launches}`` of one replay."""
        return {k.name: n for k, n, _ in self.delta}


@contextlib.contextmanager
def capture_launches():
    """Around a capture: yields a ``CapturedLaunches`` that holds, once
    the block ends, the launches counted inside it, which are taken back
    out of the counts (a capture runs nothing on the card)."""
    before = [(k, k.launches, dict(k.variant_launches)) for k in KERNELS]
    tally = CapturedLaunches()
    try:
        yield tally
    finally:
        for k, n0, v0 in before:
            n = k.launches - n0
            variants = {v: k.variant_launches[v] - m for v, m in v0.items()}
            k.launches = n0
            k.variant_launches.update(v0)
            if n or any(variants.values()):
                tally.delta.append((k, n, variants))
