"""Ragged paged attention over the serving KV pool, in plain PyTorch.

Counterpart of ``paddle_tpu/ops/paged_attention.py``, which is plain
jnp too (no Pallas kernel): gather each sequence's blocks through its
block table, mask columns past its length with ``-1e9``, softmax,
weight — the same ``1/sqrt(hd)`` scale and mask fill as the dense
cached attention in ``models/gpt.py``.

The reference pins paged-vs-dense as bit-exact; in PyTorch that does
not carry over (a softmax over 24 vs 32 or 48 columns, the tail masked,
differs by about 2.4e-7 on the CPU), so the port's tests hold the two
within 1e-6 and keep exact equality for greedy token streams.

``write_kv`` updates the pools **in place** (``index_put_``): that
takes the role of the reference's functional ``.at[].set`` plus the
engine's donated buffers, and no pool is ever copied.
"""
import math

import torch

__all__ = ['write_kv', 'paged_attention', 'gather_dense']


def write_kv(k_pool, v_pool, k_new, v_new, block_tables, slots):
    """Scatter one new token's k/v per sequence into the pools, in
    place.

    k_pool/v_pool : [num_blocks, num_heads, block_size, head_dim]
    k_new/v_new   : [S, num_heads, head_dim]
    block_tables  : [S, max_blocks] int — pool indices per sequence
    slots         : [S] int — the absolute position being written

    Rows whose table entry is the trash block (0) land there
    harmlessly.  Returns the (same) pools.
    """
    bs = k_pool.shape[2]
    slots = slots.long()
    idx = torch.div(slots, bs, rounding_mode='floor')
    bids = torch.gather(block_tables.long(), 1, idx[:, None])[:, 0]
    offs = slots % bs
    k_pool[bids, :, offs] = k_new.to(k_pool.dtype)
    v_pool[bids, :, offs] = v_new.to(v_pool.dtype)
    return k_pool, v_pool


def gather_dense(pool, block_table):
    """[num_blocks, nh, bs, hd] gathered through [S, max_blocks] tables
    -> [S, nh, max_blocks*bs, hd] (position-contiguous per sequence)."""
    S, mb = block_table.shape
    _, nh, bs, hd = pool.shape
    g = pool[block_table.long()]               # [S, mb, nh, bs, hd]
    return g.permute(0, 2, 1, 3, 4).reshape(S, nh, mb * bs, hd)


def paged_attention(q, k_pool, v_pool, block_tables, lens):
    """One ragged decode step of attention over the paged cache.

    q            : [S, num_heads, head_dim] — one query per sequence
    k_pool/v_pool: [num_blocks, num_heads, block_size, head_dim]
    block_tables : [S, max_blocks] int
    lens         : [S] int — valid length per sequence, including the
                   token just written by ``write_kv``

    -> [S, num_heads, head_dim].
    """
    hd = q.shape[-1]
    k = gather_dense(k_pool, block_tables)     # [S, nh, mb*bs, hd]
    v = gather_dense(v_pool, block_tables)
    # a pool of another dtype (PagedKVCache(dtype=)) meets q as the
    # reference's einsum promotes them
    dt = torch.promote_types(q.dtype, k.dtype)
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    scores = torch.einsum('shd,shkd->shk', q, k) * (1.0 / math.sqrt(hd))
    cols = torch.arange(k.shape[2], device=q.device)
    mask = cols[None, :] < lens.long()[:, None]
    scores = torch.where(mask[:, None, :], scores,
                         torch.full((), -1e9, dtype=scores.dtype,
                                    device=scores.device))
    att = torch.softmax(scores, dim=-1)
    return torch.einsum('shk,shkd->shd', att, v)
