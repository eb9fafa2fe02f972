"""The global random state (counterpart of ``paddle_tpu/core/rng.py``).

The reference keeps one explicit ``jax.random`` key that eager mode
splits per draw.  The port keeps one explicit ``torch.Generator`` per
device, created at first use and seeded from the global seed, so a
draw on the card stays on the card and never touches PyTorch's default
generators.  ``seed(s)`` (also ``paddle_tpu_torch.seed``) resets them
all to ``s`` and, as the reference's does, seeds ``random`` and numpy.

The bits cannot match ``jax.random``'s: the same seed gives other
draws in the two packages, so tests compare distributions or cases
with no draw (ROADMAP Queue 3).  The reference's functional key scope
serves its ``jit`` tracing; the port's compiled modules are CUDA
graphs (``core.compile_cache``), and ``register_generators`` hands a
graph the generator of its device, so each replay draws fresh
numbers and moves the generator on as the same calls run eagerly
would.  A generator keeps its identity across ``seed``, so a graph
that holds it stays valid.

A recomputed region (``core.recompute``) must draw in its recomputation
what its forward drew: while the region's forward runs, ``generator``
notes each generator it hands out the first time, with its state then
(the device's, or a named stream's of an ``RNGStatesTracker`` scope),
and ``region_replay`` puts those states back for the recomputation,
under the scopes that were active when the forward started, then moves
each generator on to where it stood, so the run draws what it would
without recompute.  That is ``get_state``/``set_state``, inside a CUDA
graph capture too: on a generator registered with the graph they read
and set the capture's place in the stream of draws, so each replay's
recomputation draws that replay's forward numbers again
(``tools/torch_rng_graph_probe.py`` holds this PyTorch to it).
"""
import contextlib
import random

import numpy as np
import torch

__all__ = ['seed', 'get_seed', 'generator', 'register_generators',
           'get_cuda_rng_state', 'set_cuda_rng_state', 'region_enter',
           'region_drew', 'region_replay', 'scoped']

_seed = 0
_generators = {}


def seed(s):
    """Reseed every device's generator, ``random`` and numpy with
    ``s``."""
    global _seed
    _seed = int(s)
    for gen in _generators.values():
        gen.manual_seed(_seed)
    random.seed(_seed)
    np.random.seed(_seed % (2 ** 32))


def get_seed():
    return _seed


def _key(device):
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device


_scopes = []    # generator factories of RNGStatesTracker scopes, innermost last


@contextlib.contextmanager
def scoped(factory):
    """Draws inside the block come from ``factory(device)`` (a named
    stream's generator) instead of the device's global generator."""
    _scopes.append(factory)
    try:
        yield
    finally:
        _scopes.pop()


def _device_generator(device):
    device = _key(device)
    gen = _generators.get(device)
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(_seed)
        _generators[device] = gen
    return gen


def generator(device):
    """The ``torch.Generator`` that draws for ``device``."""
    gen = _scopes[-1](device) if _scopes else _device_generator(device)
    for stash in _recording:
        stash.note(gen)
    return gen


def register_generators(graph, device):
    """Register the generator of ``device``, if one was handed out, with
    the CUDA graph ``graph`` before its capture begins (PyTorch
    registers its own default generator; ``core.compile_cache.
    GraphModule`` calls this).  A replay then advances the generator by
    what the captured calls drew, from where it stands, so the replays
    draw what the same calls made eagerly would.  Raises where this
    PyTorch cannot (no ``CUDAGraph.register_generator_state``)."""
    gen = _generators.get(_key(device))
    if gen is None:
        return
    if not hasattr(graph, 'register_generator_state'):
        raise RuntimeError(
            f'this PyTorch ({torch.__version__}) cannot register a '
            'torch.Generator with a CUDA graph '
            '(CUDAGraph.register_generator_state): a graph of a step '
            'that draws from core.rng cannot be captured')
    graph.register_generator_state(gen)


class _Stash:
    """What a recomputed region's forward drew from: each generator it
    was handed, with its state before its first draw, and the scopes
    active when it started."""

    def __init__(self):
        self.gens = []
        self.seen = set()
        self.scopes = list(_scopes)

    def note(self, gen):
        if id(gen) not in self.seen:
            self.seen.add(id(gen))
            self.gens.append((gen, gen.get_state()))


_recording = []     # the stashes of the regions whose forward runs now


def region_enter():
    """The stash of a recomputed region's forward, begun as it starts:
    ``generator`` fills it with each generator it hands out and its
    state.  Pass it to ``region_drew`` when the forward ends and to
    ``region_replay`` for the recomputation."""
    stash = _Stash()
    _recording.append(stash)
    return stash


def region_drew(stash):
    """The region's forward has ended: nothing more is noted."""
    for i, s in enumerate(_recording):
        if s is stash:
            del _recording[i]
            break


class region_replay:
    """The recomputation of a region under its forward's draws: its
    scopes and stashed states in, and on exit each generator back where
    it stood and the scopes as they were (so the run draws on as it
    would without the recomputation)."""

    def __init__(self, stash):
        self.stash = stash
        self.undo = []
        self.scopes = None

    def __enter__(self):
        self.undo = []
        self.scopes = list(_scopes)
        _scopes[:] = self.stash.scopes
        for g, st in self.stash.gens:
            self.undo.append((g, g.get_state()))
            g.set_state(st)

    def __exit__(self, *exc):
        for g, st in reversed(self.undo):
            g.set_state(st)
        self.undo = []
        _scopes[:] = self.scopes


def _rng_devices():
    if torch.cuda.is_available():
        return [torch.device('cuda', i)
                for i in range(torch.cuda.device_count())]
    return [torch.device('cpu')]


def get_cuda_rng_state():
    """The states of the port's generators, one a card in order (the
    CPU's where there is no card), as the reference's list of states;
    ``set_cuda_rng_state`` of it makes the next draws repeat bit for
    bit."""
    return [generator(d).get_state() for d in _rng_devices()]


def set_cuda_rng_state(state_list):
    """Restore the states ``get_cuda_rng_state`` returned."""
    if not isinstance(state_list, (list, tuple)) or not state_list:
        raise ValueError('expected the list returned by '
                         'get_cuda_rng_state')
    devices = _rng_devices()
    if len(state_list) != len(devices):
        raise ValueError(f'{len(state_list)} states for {len(devices)} '
                         'devices')
    for d, st in zip(devices, state_list):
        generator(d).set_state(st)
