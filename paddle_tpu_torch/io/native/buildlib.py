"""Compile-and-cache for the port's native host components (counterpart
of ``paddle_tpu/io/native/buildlib.py``).

The library is built with g++ into ``build/paddle_tpu_torch/native/`` at
the repository root (which ``.gitignore`` lists), under a name keyed by
a hash of the source and the flags, so an edit builds anew; each process
builds into a temporary name of its own and installs it atomically.
"""
import ctypes
import hashlib
import os
import subprocess

__all__ = ['BUILD_DIR', 'compile_cached', 'library_path']

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build',
                         'paddle_tpu_torch', 'native')
CXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')


def library_path(src, prefix, extra_flags=()):
    """Where ``compile_cached`` puts the library of ``src``."""
    with open(src, 'rb') as f:
        hasher = hashlib.sha256(f.read())
    hasher.update(' '.join(CXX_FLAGS + tuple(extra_flags)).encode())
    return os.path.join(BUILD_DIR,
                        f'_{prefix}_{hasher.hexdigest()[:16]}.so')


def compile_cached(src, prefix, extra_flags=()):
    """g++-compile ``src`` once into ``library_path``; returns the CDLL.
    Raises on any build failure: the caller decides its fallback."""
    so = library_path(src, prefix, extra_flags)
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f'{so}.{os.getpid()}.tmp'
        subprocess.run(['g++', *CXX_FLAGS, *extra_flags, src, '-o', tmp],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    return ctypes.CDLL(so)
