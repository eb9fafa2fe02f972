"""Wide&Deep and DeepFM, the sparse-embedding recommender models
(counterpart of ``paddle_tpu/models/widedeep.py``).

All sparse fields share one table per role, addressed by per-field
offsets (``_FusedSparseEmbedding``): one gather a role.  The offsets are
a non-persistent buffer, so the state-dict keys are the reference's
(``wide.table.weight``, ``deep_emb.table.weight``, ...); ids and
offsets are gathered as int64 (the reference casts them to int32, and
the bench's 2.6 M rows fit either).  ``shard_vocab=True`` builds the
tables as ``VocabParallelEmbedding``, a plain table on one device (its
init is XavierNormal where ``nn.Embedding`` draws N(0, 1), as in the
reference); ``fused_gather=False`` is the reference's per-field baseline
(``_PerFieldSparseEmbedding``), which does not shard.

Every op the reference dispatches by name (``sum``, ``getitem``,
``reshape``, ``concat``, ``add``, ``subtract``, ``multiply``) casts its
inputs through the AMP policy under that name, so under O2 the sums run
in f32 and the rest in bf16, as there.  ``device=None`` is the CUDA
card; ``seed`` draws the init from an explicit CPU generator.
"""
import numpy as np
import torch

from .. import nn
from ..amp import amp_cast
from ..core.device import resolve_device
from ..distributed.fleet.meta_parallel import VocabParallelEmbedding
from ..nn.layer.layers import create_parameter
from ..tensor import manipulation, math as pmath
from ..vision.models._init import SeededModel

__all__ = ['WideDeep', 'DeepFM']


class _FusedSparseEmbedding(torch.nn.Module):
    """One table for all sparse fields; ids are per-field local and get
    offset into the fused vocab."""

    def __init__(self, field_dims, embed_dim, shard=False, device=None):
        super().__init__()
        total = int(sum(field_dims))
        offsets = np.array([0] + list(np.cumsum(field_dims)[:-1]),
                           dtype=np.int64)
        self.register_buffer('offsets', torch.from_numpy(offsets).to(device),
                             persistent=False)
        table = VocabParallelEmbedding if shard else nn.Embedding
        self.table = table(total, embed_dim, device=device)

    def forward(self, ids):
        """ids [B, F] (field-local) -> embeddings [B, F, E]."""
        return self.table(pmath.add(ids, self.offsets))


class _PerFieldSparseEmbedding(torch.nn.Module):
    """One table per field (the reference's per-slot lookups): F
    gathers and a stack."""

    def __init__(self, field_dims, embed_dim, device=None):
        super().__init__()
        self.tables = nn.LayerList(
            [nn.Embedding(int(d), embed_dim, device=device)
             for d in field_dims])

    def forward(self, ids):
        """ids [B, F] (field-local) -> embeddings [B, F, E]."""
        return manipulation.stack(
            [t(ids[:, i]) for i, t in enumerate(self.tables)], axis=1)


def _first_order(emb):
    """``sum(emb, axis=[1, 2], keepdim=True)[:, :, 0]``: [B, 1]."""
    s = pmath.sum(emb, axis=[1, 2], keepdim=True)
    s, = amp_cast('getitem', s)
    return s[:, :, 0]


def _mlp(in_dim, hidden, device):
    layers = []
    for h in hidden:
        layers += [nn.Linear(in_dim, h, device=device), nn.ReLU()]
        in_dim = h
    layers.append(nn.Linear(in_dim, 1, device=device))
    return nn.Sequential(*layers)


class WideDeep(SeededModel):
    """wide (first-order sparse + dense linear) + deep (embeddings into
    an MLP).

    Args:
        sparse_field_dims: vocab size per sparse field.
        dense_dim: number of dense float features (0 to disable).
        embed_dim: deep embedding width.
        hidden: deep MLP widths.
        shard_vocab: build the fused tables as ``VocabParallelEmbedding``.
        fused_gather: one offset-addressed table per role (default) or
            per-field tables (not shardable).
    """

    def __init__(self, sparse_field_dims, dense_dim=0, embed_dim=16,
                 hidden=(64, 32), shard_vocab=False, fused_gather=True,
                 device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        self.dense_dim = dense_dim
        f = len(sparse_field_dims)
        if not fused_gather and shard_vocab:
            raise ValueError('per-field tables (fused_gather=False) '
                             'do not shard over tp; use the fused '
                             'table for shard_vocab=True')
        if fused_gather:
            self.wide = _FusedSparseEmbedding(sparse_field_dims, 1,
                                              shard=shard_vocab,
                                              device=device)
            self.deep_emb = _FusedSparseEmbedding(
                sparse_field_dims, embed_dim, shard=shard_vocab,
                device=device)
        else:
            self.wide = _PerFieldSparseEmbedding(sparse_field_dims, 1,
                                                 device=device)
            self.deep_emb = _PerFieldSparseEmbedding(
                sparse_field_dims, embed_dim, device=device)
        self.deep = _mlp(f * embed_dim + dense_dim, hidden, device)
        self.dense_linear = nn.Linear(dense_dim, 1, device=device) \
            if dense_dim else None
        self.bias = create_parameter([1], is_bias=True, device=device)
        self.init_weights(seed)

    def forward(self, sparse_ids, dense=None):
        B = sparse_ids.shape[0]
        wide = _first_order(self.wide(sparse_ids))          # [B, 1]
        emb = self.deep_emb(sparse_ids)                     # [B, F, E]
        deep_in = manipulation.reshape(emb, [B, -1])
        if self.dense_linear is not None and dense is not None:
            wide = pmath.add(wide, self.dense_linear(dense))
            deep_in = manipulation.concat([deep_in, dense], axis=1)
        deep = self.deep(deep_in)                           # [B, 1]
        return pmath.add(pmath.add(wide, deep), self.bias)


class DeepFM(SeededModel):
    """Factorization-machine second-order interactions + a deep MLP
    over the same fused embeddings (one gather feeds both)."""

    def __init__(self, sparse_field_dims, dense_dim=0, embed_dim=16,
                 hidden=(64, 32), shard_vocab=False, device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        self.dense_dim = dense_dim
        f = len(sparse_field_dims)
        self.first_order = _FusedSparseEmbedding(
            sparse_field_dims, 1, shard=shard_vocab, device=device)
        self.emb = _FusedSparseEmbedding(sparse_field_dims, embed_dim,
                                         shard=shard_vocab, device=device)
        self.deep = _mlp(f * embed_dim + dense_dim, hidden, device)
        self.dense_linear = nn.Linear(dense_dim, 1, device=device) \
            if dense_dim else None
        self.bias = create_parameter([1], is_bias=True, device=device)
        self.init_weights(seed)

    def forward(self, sparse_ids, dense=None):
        B = sparse_ids.shape[0]
        first = _first_order(self.first_order(sparse_ids))  # [B, 1]
        e = self.emb(sparse_ids)                            # [B, F, E]
        # FM: 0.5 * ((sum_f e)^2 - sum_f e^2), summed over E
        s = pmath.sum(e, axis=1)                            # [B, E]
        sq = pmath.sum(pmath.multiply(e, e), axis=1)
        fm = pmath.multiply(0.5, pmath.sum(
            pmath.subtract(pmath.multiply(s, s), sq), axis=1,
            keepdim=True))                                  # [B, 1]
        deep_in = manipulation.reshape(e, [B, -1])
        if self.dense_linear is not None and dense is not None:
            first = pmath.add(first, self.dense_linear(dense))
            deep_in = manipulation.concat([deep_in, dense], axis=1)
        deep = self.deep(deep_in)
        return pmath.add(pmath.add(pmath.add(first, fm), deep), self.bias)
