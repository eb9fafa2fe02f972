"""Paged KV cache: fixed-size blocks in one preallocated pool.

Counterpart of ``paddle_tpu/serving/kv_cache.py``.  Each layer owns
ONE device pool ``[num_blocks, num_heads, block_size, head_dim]`` (f32)
allocated once at engine construction; every live sequence owns an
ordered list of pool blocks (its *block table*).  Admission allocates
blocks and eviction frees them on the host; the device pools are never
reallocated.

The pools are updated **in place** (``index_put_`` in
``ops/paged_attention.write_kv`` and in the engine's prefill scatter).
That takes the role of the reference's functional updates with donated
buffers: no step copies a pool.

Block 0 is the **trash block**: inactive batch slots point their
tables at it so their masked writes land somewhere harmless.  The
allocator never hands it out, and ``audit()`` proves the invariants:
a block is owned by at most one sequence, owned and free sets never
intersect, nothing leaks.
"""
import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ['PagedKVCache', 'PagedCacheView', 'TRASH_BLOCK', 'blocks_for']

TRASH_BLOCK = 0


def blocks_for(num_positions, block_size):
    """Blocks needed to hold `num_positions` cache slots."""
    return -(-int(num_positions) // int(block_size))


class PagedCacheView:
    """One layer's paged cache as a decode step sees it.

    - ``slots`` [S]: the absolute position this step WRITES (each
      sequence's context length before its new token);
    - ``lens`` [S]: the valid length the attention READS (slots + 1).

    ``models/gpt.py::CausalSelfAttention`` dispatches on the ``paged``
    marker and writes the pools in place.
    """

    paged = True

    def __init__(self, k_pool, v_pool, block_table, slots, lens):
        self.k_pool = k_pool
        self.v_pool = v_pool
        self.block_table = block_table
        self.slots = slots
        self.lens = lens


class PagedKVCache:
    """The pools + their host-side block allocator.

    Device state: ``pools`` — one (k_pool, v_pool) pair per layer.
    Host state: a free list and the per-sequence owned-block lists.
    Allocation never partially succeeds: asking for more blocks than
    are free changes nothing and returns False.  ``device_init=False``
    builds the allocator alone (no device needed).
    """

    def __init__(self, num_layers, num_heads, head_dim, *,
                 block_size, num_blocks, dtype=None, device=None,
                 device_init=True):
        if num_blocks < 2:
            raise ValueError('num_blocks must be >= 2 (block 0 is the '
                             'reserved trash block)')
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        # the pools' dtype: a torch dtype or its name, float32 by default
        self.dtype = getattr(torch, dtype) if isinstance(dtype, str) \
            else (dtype or torch.float32)
        if device_init:
            self.device = resolve_device(device)
            shape = (self.num_blocks, self.num_heads, self.block_size,
                     self.head_dim)
            self.pools = [(torch.zeros(shape, dtype=self.dtype,
                                       device=self.device),
                           torch.zeros(shape, dtype=self.dtype,
                                       device=self.device))
                          for _ in range(self.num_layers)]
        else:
            self.device = None
            self.pools = None
        # LIFO free list: freshly freed blocks are the warmest
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._owned = {}            # seq_id -> [block ids, in order]
        self._high_water = 0        # max blocks ever simultaneously owned

    # -- allocator ----------------------------------------------------------
    @property
    def free_blocks(self):
        return len(self._free)

    def owned(self, seq_id):
        return list(self._owned.get(seq_id, ()))

    def ensure(self, seq_id, num_positions):
        """Grow `seq_id`'s block list to cover `num_positions` cache
        slots.  All-or-nothing: False (and no change) when the free
        list cannot cover the growth."""
        have = self._owned.setdefault(seq_id, [])
        need = blocks_for(num_positions, self.block_size) - len(have)
        if need <= 0:
            return True
        if need > len(self._free):
            return False
        for _ in range(need):
            have.append(self._free.pop())
        used = (self.num_blocks - 1) - len(self._free)
        if used > self._high_water:
            self._high_water = used
        return True

    def frag_report(self):
        """How broken up the pool is, not just how full: maximal runs
        of consecutive free block ids, ``frag_frac`` = 1 -
        largest_run/free, per-sequence block spread, lifetime peak."""
        usable = self.num_blocks - 1
        free = sorted(self._free)
        runs = []
        if free:
            start = prev = free[0]
            for b in free[1:]:
                if b == prev + 1:
                    prev = b
                    continue
                runs.append(prev - start + 1)
                start = prev = b
            runs.append(prev - start + 1)
        largest = max(runs) if runs else 0
        spreads = []
        for blocks in self._owned.values():
            if blocks:
                spreads.append(
                    (max(blocks) - min(blocks) + 1) / len(blocks))
        return {
            'num_blocks': self.num_blocks,
            'usable_blocks': usable,
            'free_blocks': len(free),
            'owned_blocks': usable - len(free),
            'owned_seqs': sum(1 for b in self._owned.values() if b),
            'free_runs': len(runs),
            'largest_free_run': largest,
            'frag_frac': round(1.0 - largest / len(free), 4)
            if free else 0.0,
            'seq_spread_max': round(max(spreads), 4) if spreads else 0.0,
            'seq_spread_mean': round(sum(spreads) / len(spreads), 4)
            if spreads else 0.0,
            'high_water_blocks': self._high_water,
        }

    def free_seq(self, seq_id):
        """Release every block `seq_id` owns; returns how many."""
        blocks = self._owned.pop(seq_id, [])
        self._free.extend(reversed(blocks))
        return len(blocks)

    def table_row(self, seq_id, width):
        """`seq_id`'s block table padded (with the trash block) to a
        fixed `width`."""
        blocks = self._owned.get(seq_id, ())
        if len(blocks) > width:
            raise ValueError(
                f'sequence {seq_id} owns {len(blocks)} blocks > table '
                f'width {width}')
        row = np.full((width,), TRASH_BLOCK, np.int32)
        row[:len(blocks)] = blocks
        return row

    def audit(self):
        """Invariant check; returns a list of violation strings (empty
        = healthy)."""
        problems = []
        seen = {}
        for sid, blocks in self._owned.items():
            for b in blocks:
                if b == TRASH_BLOCK or not 0 < b < self.num_blocks:
                    problems.append(f'seq {sid} owns illegal block {b}')
                if b in seen:
                    problems.append(
                        f'block {b} aliased by seqs {seen[b]} and {sid}')
                seen[b] = sid
        free = set(self._free)
        if len(free) != len(self._free):
            problems.append('free list holds duplicates')
        both = free & set(seen)
        if both:
            problems.append(f'blocks {sorted(both)} both free and owned')
        if TRASH_BLOCK in free:
            problems.append('trash block on the free list')
        if len(free) + len(seen) != self.num_blocks - 1:
            problems.append(
                f'leak: {self.num_blocks - 1 - len(free) - len(seen)} '
                'block(s) neither free nor owned')
        return problems
