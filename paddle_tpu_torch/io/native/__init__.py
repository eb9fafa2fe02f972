"""ctypes bindings and build of the native prefetch ring buffer
(counterpart of ``paddle_tpu/io/native``; the port has the ring and the
batch wire format, ``pack_batch``/``unpack_batch``).

``ringbuf.cpp`` (a copy of the reference's) is compiled with g++ at
first use into ``build/paddle_tpu_torch/native/`` at the repository
root, under a name keyed by a hash of the source and the flags
(``buildlib.compile_cached``); no library is kept beside the source.
Without a compiler ``available()`` is False and the DataLoader keeps
the pure-Python queue path, as the reference does.
"""
import ctypes
import os
import pickle
import struct
import threading

import numpy as np

__all__ = ['available', 'pack_batch', 'pack_error', 'unpack_batch',
           'NativeRing', 'batches_carried']

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, 'ringbuf.cpp')

_lib = None
_lib_err = None
_build_lock = threading.Lock()
_carried = [0]          # payloads popped from any ring, process-wide


def batches_carried():
    """How many payloads the native rings of this process handed to a
    consumer (the evidence that a loader path went through the ring)."""
    return _carried[0]


def _build():
    from .buildlib import compile_cached
    lib = compile_cached(_SRC, 'ringbuf', extra_flags=('-pthread',))
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [ctypes.c_int64]
    lib.rb_destroy.argtypes = [ctypes.c_void_p]
    lib.rb_push.restype = ctypes.c_int
    lib.rb_push.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                            ctypes.c_char_p, ctypes.c_int64]
    lib.rb_wait_next.restype = ctypes.c_int64
    lib.rb_wait_next.argtypes = [ctypes.c_void_p]
    lib.rb_pop.restype = ctypes.c_int64
    lib.rb_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int64]
    lib.rb_close.argtypes = [ctypes.c_void_p]
    return lib


def available():
    global _lib, _lib_err
    if _lib is not None:
        return True
    if _lib_err is not None:
        return False
    with _build_lock:
        if _lib is not None:
            return True
        try:
            _lib = _build()
            return True
        except Exception as e:  # no g++, or an unwritable build dir
            _lib_err = e
            return False


# -- batch packing -----------------------------------------------------------
# wire format: [kind u8]  kind 0 = arrays, 1 = pickled payload (errors,
# non-array batches).  arrays: [n u32] then per array
# [dtype_len u32][dtype utf8][ndim u32][shape i64*ndim][nbytes i64][data]

def pack_error(exc):
    """Exceptions cross the ring pickled.  The original object is kept
    when it survives a pickle round-trip (so `except FileNotFoundError`
    style handlers behave identically to the threaded path); otherwise a
    RuntimeError wrapper carries type name + traceback."""
    import traceback
    try:
        payload = pickle.dumps(exc, protocol=pickle.HIGHEST_PROTOCOL)
        pickle.loads(payload)  # multi-arg __init__s explode here, not
        return b'\x01' + payload  # in the consumer
    except Exception:
        msg = '{}: {}\n{}'.format(type(exc).__name__, exc,
                                   traceback.format_exc())
        return b'\x01' + pickle.dumps(RuntimeError(msg),
                                       protocol=pickle.HIGHEST_PROTOCOL)


def pack_batch(batch):
    parts = []
    arrays = None
    if isinstance(batch, (list, tuple)) and batch and all(
            isinstance(a, np.ndarray) and a.dtype.kind in 'biufc'
            for a in batch):
        arrays = list(batch)
    if arrays is None:
        payload = pickle.dumps(batch, protocol=pickle.HIGHEST_PROTOCOL)
        return b'\x01' + payload
    parts.append(b'\x00')
    parts.append(struct.pack('<I', len(arrays)))
    for a in arrays:
        a = np.ascontiguousarray(a)
        dt = a.dtype.str.encode()
        parts.append(struct.pack('<I', len(dt)))
        parts.append(dt)
        parts.append(struct.pack('<I', a.ndim))
        parts.append(struct.pack(f'<{a.ndim}q', *a.shape))
        raw = a.tobytes()
        parts.append(struct.pack('<q', len(raw)))
        # pad data to a 64B boundary so unpacked arrays are aligned
        off = sum(len(p) for p in parts)
        pad = (-off) % 64
        parts.append(b'\x00' * pad)
        parts.append(raw)
    return b''.join(parts)


def unpack_batch(buf):
    # buf: bytes or a uint8 numpy view (pop() returns the latter)
    if int(buf[0]) == 1:
        return pickle.loads(bytes(memoryview(buf)[1:]))
    off = 1
    (n,) = struct.unpack_from('<I', buf, off)
    off += 4
    out = []
    for _ in range(n):
        (dl,) = struct.unpack_from('<I', buf, off)
        off += 4
        dt = np.dtype(bytes(memoryview(buf)[off:off + dl]).decode())
        off += dl
        (nd,) = struct.unpack_from('<I', buf, off)
        off += 4
        shape = struct.unpack_from(f'<{nd}q', buf, off)
        off += 8 * nd
        (nb,) = struct.unpack_from('<q', buf, off)
        off += 8
        off += (-off) % 64  # skip alignment padding
        a = np.frombuffer(buf, dtype=dt, count=nb // dt.itemsize,
                          offset=off).reshape(shape)
        off += nb
        out.append(a)
    return out


class NativeRing:
    """In-order bounded ring over the C++ library."""

    def __init__(self, capacity):
        assert available()
        self._h = _lib.rb_create(capacity)
        self._closed = False

    def push(self, seq, payload: bytes):
        r = _lib.rb_push(self._h, seq, payload, len(payload))
        if r == -2:
            raise MemoryError('ring slot allocation failed')
        return r == 0  # False → ring closed

    def pop(self):
        """Next in-order payload as a writable, 64B-aligned uint8 view
        (so the per-array padding from pack_batch yields aligned numpy
        arrays); the slot->buffer memcpy is the only consumer-side copy.
        Returns None when closed+drained."""
        n = _lib.rb_wait_next(self._h)
        if n < 0:
            return None
        n = int(n)
        backing = np.empty(n + 63, dtype=np.uint8)
        start = (-backing.ctypes.data) % 64
        view = backing[start:start + n]
        c_buf = (ctypes.c_char * n).from_buffer(view)
        got = _lib.rb_pop(self._h, c_buf, n)
        if got < 0:
            return None
        _carried[0] += 1
        return view

    def close(self):
        if not self._closed:
            self._closed = True
            _lib.rb_close(self._h)

    def __del__(self):
        try:
            self.close()
            if self._h:
                _lib.rb_destroy(self._h)
                self._h = None
        except Exception:
            pass
