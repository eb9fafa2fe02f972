"""Token sampling shared by ``generate`` and the serving engine.

Counterpart of ``paddle_tpu/ops/sampling.py``, keeping its discipline:
a sampled token is a pure function of (seed, absolute position, row),
never of batch composition or scheduling history.  ``generate`` shares
one seed across its batch and tells rows apart by index; the serving
engine gives each request its own seed and always uses row 0, which is
what a batch-1 ``generate`` computes — so the two draw the same token.

The bits cannot match ``jax.random``.  Instead of a generator per row,
a counter-based hash of (seed, pos, row, vocab index) in int64 tensor
ops gives one uniform per logit, and Gumbel-max turns them into an
exact draw from ``softmax(logits / temperature)``.  Greedy
(temperature 0 or None) is the argmax and ignores all of that.
"""
import torch

__all__ = ['sample_rows', 'make_row_sampler']

_M32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer finalizer on int64 tensors holding values below
    2**32; both multipliers are below 2**31, so no product overflows."""
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _M32
    x = ((x ^ (x >> 15)) * 0x68E31DA5) & _M32
    return x ^ (x >> 16)


def _uniforms(seeds, pos, rows, vocab):
    """``[B, vocab]`` float64 uniforms in (0, 1), each a pure function
    of (seeds[b], pos[b], rows[b], vocab index)."""
    k = _mix32(seeds.long() & _M32)
    k = _mix32(k ^ (pos.long() & _M32))
    k = _mix32(k ^ (rows.long() & _M32))
    idx = torch.arange(vocab, device=k.device, dtype=torch.int64)
    h = _mix32(k[:, None] ^ ((idx * 0x9E3779B1) & _M32))
    h = _mix32(h ^ k[:, None])
    return (h.double() + 0.5) / 4294967296.0


def _draw(logits, seeds, pos, rows, temperature, top_k):
    lg = logits.double() / float(temperature)
    if top_k is not None:
        kth = torch.topk(lg, int(top_k), dim=-1).values[:, -1:]
        lg = torch.where(lg < kth, torch.full_like(lg, -1e9), lg)
    u = _uniforms(seeds, pos, rows, lg.shape[-1])
    return torch.argmax(lg - torch.log(-torch.log(u)), dim=-1)


def _greedy(temperature):
    return temperature == 0 or temperature is None


def _per_row(value, B, dev):
    """``[B]`` int64 copies of one scalar: a Python int, or a 0-d device
    tensor read on the device (no host read, so a graph can capture
    the draw with the seed and the position as its inputs)."""
    if torch.is_tensor(value):
        return value.to(device=dev, dtype=torch.int64).reshape(1).expand(B)
    return torch.full((B,), int(value), device=dev, dtype=torch.int64)


def sample_rows(logits, seed, pos, temperature, top_k):
    """``generate``'s batch form: every row shares ``seed`` and the
    absolute position ``pos`` (each an int or a 0-d tensor; the draws
    are the same either way); rows differ by index.  ``logits`` is
    ``[B, V]``; returns ``[B]`` int64."""
    if _greedy(temperature):
        return torch.argmax(logits, dim=-1)
    B = logits.shape[0]
    dev = logits.device
    rows = torch.arange(B, device=dev, dtype=torch.int64)
    return _draw(logits, _per_row(seed, B, dev), _per_row(pos, B, dev),
                 rows, temperature, top_k)


def make_row_sampler(temperature, top_k):
    """The serving engine's form: ``sample(logits[B, V], seeds[B],
    pos[B]) -> [B]`` with each row's own seed and position and row 0."""
    greedy = _greedy(temperature)

    def sample(logits, seeds, pos):
        if greedy:
            return torch.argmax(logits, dim=-1)
        return _draw(logits, seeds, pos, torch.zeros_like(seeds),
                     temperature, top_k)

    return sample
