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
serves its ``jit`` tracing, which the eager port has no counterpart
of.
"""
import random

import numpy as np
import torch

__all__ = ['seed', 'get_seed', 'generator']

_seed = 0
_generators = {}


def seed(s):
    """Reseed every device's generator (at its next use), ``random``
    and numpy with ``s``."""
    global _seed
    _seed = int(s)
    _generators.clear()
    random.seed(_seed)
    np.random.seed(_seed % (2 ** 32))


def get_seed():
    return _seed


def generator(device):
    """The ``torch.Generator`` that draws for ``device``."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    gen = _generators.get(device)
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(_seed)
        _generators[device] = gen
    return gen
