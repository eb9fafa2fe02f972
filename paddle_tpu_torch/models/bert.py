"""BERT encoder + pretraining heads (counterpart of
``paddle_tpu/models/bert.py``).

Post-LN encoder layers with the reference's dropouts, names and
state-dict keys, so ``convert.load_numpy_state`` carries the JAX
model's weights across unchanged.  Attention takes the non-causal flash
kernels (``ops/flash_attention.py``) while dropout is inactive and no
mask is given, and otherwise the reference's plain branch: scores,
scale, ``+ attn_mask``, ``F.softmax`` (the hand-written softmax kernel,
``ops/fused_softmax.py``), dropout, the product with v.  Each layer's
fc+GELU goes through ``mlp_gelu`` (the GEMM+GELU kernels with
``ops.fused_gelu_linear.USE_PALLAS_MLP`` on), every LayerNorm through
the LayerNorm kernel.  ``loss`` is MLM cross entropy with ``-100``
labels ignored, through the fused MLM head (``ops/fused_ce.py``) when
``fused_head`` is on, plus the NSP term when NSP labels are given.

The model is built in training mode, as the reference's layers are;
``device=None`` is the CUDA card, ``seed`` draws the init from an
explicit CPU ``torch.Generator``.  Dropout draws come from the
device's generator (``core.rng``).

Over a mesh: the layers are ``fleet.meta_parallel``'s, so under ``tp``
each rank holds ``num_heads / tp`` heads (whole heads of the fused
qkv), the MLP's column and row shards and the word embedding's vocab
rows; the tied decoder's input crosses ``copy_to_region`` and the MLM
loss is the vocab-parallel cross entropy.  The MLM mean divides the
masked sum by the count of labels that are not ``-100`` over the whole
global batch: inside a training step over ``dp`` (``collective.
axis_scope``) the count is all-reduced over ``dp`` and the rank's sum
scaled by the ``dp`` size, so the ranks' mean is the reference's loss
whatever each rank's share of the masked tokens.  Attention dropout
under ``tp`` draws from the ``model_parallel`` stream.
"""
import math

import torch
from torch import nn

from ..amp import amp_cast
from ..core.device import resolve_device
from ..distributed import collective
from ..distributed.fleet.meta_parallel import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    copy_to_region, parallel_cross_entropy, tp_state)
from ..nn import functional as F
from ..nn.layer.common import Dropout, Embedding, Linear
from ..nn.layer.layers import deferred_init
from ..nn.layer.norm import LayerNorm
from ..ops.flash_attention import can_use_pallas, flash_attention
from ..ops.fused_ce import (fused_linear_cross_entropy,
                            fused_linear_cross_entropy_tp)
from ..ops.fused_gelu_linear import mlp_gelu
from .gpt import _add, local_heads, tp_dropout

__all__ = ['BertConfig', 'BertModel', 'BertForPretraining', 'bert_tiny',
           'bert_base', 'bert_large']


class BertConfig:
    """The reference ``BertConfig``: every field, the same defaults."""

    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, max_seq_len=512, type_vocab_size=2,
                 intermediate_size=None, dropout=0.1,
                 layer_norm_epsilon=1e-12, fused_head=False,
                 fused_head_chunks=8):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_seq_len = max_seq_len
        self.type_vocab_size = type_vocab_size
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.dropout = dropout
        self.layer_norm_epsilon = layer_norm_epsilon
        # fused MLM head: the training forward returns the transformed
        # hidden states and loss() fuses the tied decoder matmul with
        # the softmax CE over vocab chunks
        self.fused_head = fused_head
        self.fused_head_chunks = fused_head_chunks


class BertSelfAttention(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        if cfg.hidden_size % cfg.num_heads:
            raise ValueError('hidden_size must be a multiple of num_heads')
        self.n_head = local_heads(cfg.num_heads)
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self._tp_group = tp_state()[0]
        self.qkv = ColumnParallelLinear(cfg.hidden_size,
                                        3 * cfg.hidden_size,
                                        gather_output=False, device=device,
                                        groups=3)
        self.proj = RowParallelLinear(cfg.hidden_size, cfg.hidden_size,
                                      input_is_parallel=True, device=device)
        self.drop = Dropout(cfg.dropout)

    def _use_flash(self, T):
        dropout_active = self.training and self.drop.p > 0.0
        return not dropout_active and can_use_pallas(T, T, self.head_dim)

    def forward(self, x, attn_mask=None):
        B, T, H = x.shape
        nh, hd = self.n_head, self.head_dim
        qkv = self.qkv(x).reshape(B, T, 3, nh, hd)
        q = qkv[:, :, 0].transpose(1, 2)             # [B, nh, T, hd]
        k = qkv[:, :, 1].transpose(1, 2)
        v = qkv[:, :, 2].transpose(1, 2)
        if attn_mask is None and self._use_flash(T):
            q, k, v = amp_cast('flash_attention', q, k, v)
            y = flash_attention(q.reshape(B * nh, T, hd),
                                k.reshape(B * nh, T, hd),
                                v.reshape(B * nh, T, hd), causal=False)
            y = y.reshape(B, nh, T, hd)
        else:
            q, k = amp_cast('matmul', q, k)
            att = torch.matmul(q, k.transpose(-1, -2))
            att, = amp_cast('multiply', att)
            att = att * (1.0 / math.sqrt(hd))
            if attn_mask is not None:
                att = _add(att, torch.as_tensor(attn_mask,
                                                device=att.device))
            att = F.softmax(att, axis=-1)
            att = tp_dropout(self.drop, att, self._tp_group)
            att, v = amp_cast('matmul', att, v)
            y = torch.matmul(att, v)
        y = y.transpose(1, 2).reshape(B, T, nh * hd)
        return self.proj(y)


class BertLayer(nn.Module):
    """Post-LN encoder block (the original BERT ordering)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.attn = BertSelfAttention(cfg, device=device)
        self.ln1 = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_epsilon,
                             device=device)
        self.fc = ColumnParallelLinear(cfg.hidden_size,
                                       cfg.intermediate_size,
                                       gather_output=False, device=device)
        self.proj = RowParallelLinear(cfg.intermediate_size,
                                      cfg.hidden_size,
                                      input_is_parallel=True, device=device)
        self.ln2 = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_epsilon,
                             device=device)
        self.drop = Dropout(cfg.dropout)

    def forward(self, x, attn_mask=None):
        x = self.ln1(_add(x, self.drop(self.attn(x, attn_mask))))
        h = self.proj(mlp_gelu(x, self.fc))
        return self.ln2(_add(x, self.drop(h)))


class BertModel(nn.Module):
    def __init__(self, config, device=None):
        super().__init__()
        self.config = config
        self.word_emb = VocabParallelEmbedding(config.vocab_size,
                                               config.hidden_size,
                                               device=device)
        self.pos_emb = Embedding(config.max_seq_len, config.hidden_size,
                                 device=device)
        self.type_emb = Embedding(config.type_vocab_size,
                                  config.hidden_size, device=device)
        self.ln = LayerNorm(config.hidden_size,
                            epsilon=config.layer_norm_epsilon, device=device)
        self.drop = Dropout(config.dropout)
        self.layers = nn.ModuleList([BertLayer(config, device=device)
                                     for _ in range(config.num_layers)])
        self.pooler = Linear(config.hidden_size, config.hidden_size,
                             device=device)

    def forward(self, input_ids, token_type_ids=None, attn_mask=None):
        T = input_ids.shape[1]
        if T > self.config.max_seq_len:
            raise ValueError(f'sequence length {T} exceeds max_seq_len '
                             f'{self.config.max_seq_len}')
        x = _add(self.word_emb(input_ids),
                 F.embedding_prefix(self.pos_emb.weight, T))
        if token_type_ids is not None:
            x = _add(x, self.type_emb(token_type_ids))
        x = self.drop(self.ln(x))
        for layer in self.layers:
            x = layer(x, attn_mask)
        pooled = F.tanh(self.pooler(x[:, 0]))
        return x, pooled


class BertForPretraining(nn.Module):
    """MLM (tied decoder) + NSP heads; ``loss()`` = MLM CE + NSP CE."""

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        self.device = resolve_device(device)
        self.config = config
        with deferred_init():       # init_weights draws every parameter
            self.bert = BertModel(config, device=self.device)
            self.mlm_transform = Linear(config.hidden_size,
                                        config.hidden_size,
                                        device=self.device)
            self.mlm_ln = LayerNorm(config.hidden_size,
                                    epsilon=config.layer_norm_epsilon,
                                    device=self.device)
            self.nsp = Linear(config.hidden_size, 2, device=self.device)
        self.init_weights(torch.Generator().manual_seed(int(seed)))

    def init_weights(self, generator):
        """The reference's default init, drawn from ``generator``."""
        for m in self.modules():
            if m is not self and hasattr(m, 'reset_parameters'):
                m.reset_parameters(generator)

    def load_numpy_state(self, params):
        """Load the JAX model's ``functional_state()[0]`` as numpy;
        raises on a missing or extra key or a shape/dtype mismatch."""
        from ..convert import load_numpy_state
        load_numpy_state(self, params)
        return self

    def forward(self, input_ids, token_type_ids=None):
        seq, pooled = self.bert(input_ids, token_type_ids)
        h = self.mlm_ln(F.gelu(self.mlm_transform(seq), approximate=True))
        nsp_logits = self.nsp(pooled)
        if self.config.fused_head and self.training:
            # the tied-decoder matmul happens inside loss()
            return h, nsp_logits
        h = copy_to_region(h, self.bert.word_emb._tp_group)
        h, w = amp_cast('matmul', h, self.bert.word_emb.weight)
        return torch.matmul(h, w.t()), nsp_logits

    def loss(self, outputs, mlm_labels, nsp_labels=None):
        """MLM cross entropy over the positions whose label is not
        ``-100`` (mean over them, at least 1), plus the NSP cross
        entropy when ``nsp_labels`` are given.  The fused branch is
        keyed off the shape the forward produced, as in the
        reference.  Over ``dp`` and ``tp`` see the module docstring."""
        logits, nsp_logits = outputs
        cfg = self.config
        B, T, D = logits.shape
        labels = torch.as_tensor(mlm_labels, device=logits.device) \
            .reshape(B * T).long()
        emb = self.bert.word_emb
        group, dp = emb._tp_group, collective.scope_group('dp')
        valid = labels != -100
        if cfg.fused_head and D == cfg.hidden_size and \
                D != emb.num_embeddings:
            h, w = amp_cast('fused_mlm_head_ce', logits, emb.weight)
            if group is not None:
                losses = fused_linear_cross_entropy_tp(
                    h.reshape(B * T, D), w.t(), labels, group=group,
                    num_chunks=cfg.fused_head_chunks)
            else:
                losses = fused_linear_cross_entropy(
                    h.reshape(B * T, D), w.t(), labels,
                    num_chunks=cfg.fused_head_chunks)
            # -100 labels land in no vocab chunk; masking the loss zeroes
            # both the value and the gradient
            mlm = _masked_mean(
                torch.where(valid, losses, torch.zeros_like(losses)),
                valid, dp)
        elif group is not None or dp is not None:
            per = parallel_cross_entropy(logits.reshape(B * T, D), labels,
                                         group, emb.vocab_start)
            mlm = _masked_mean(per.float(), valid, dp)
        else:
            mlm = F.cross_entropy(logits.reshape(B * T, D), labels,
                                  ignore_index=-100)
        if nsp_labels is None:
            return mlm
        nsp = torch.as_tensor(nsp_labels, device=logits.device)
        return _add(mlm, F.cross_entropy(nsp_logits, nsp))


def _masked_mean(per, valid, dp):
    """The masked sum over the count of valid labels (at least 1); with
    ``dp`` (the step's data-parallel group) the count is the global one
    and the sum scaled by the group's size, so the ranks' mean is the
    global masked mean."""
    n = valid.sum().to(per.dtype)
    if dp is None:
        return per.sum() / n.clamp_min(1)
    n = collective.all_reduce(n.detach().clone(), group=dp)
    return per.sum() * float(dp.nranks) / n.clamp_min(1)


def bert_tiny(device=None, seed=0, **kw):
    """4-layer toy config for tests."""
    kw.setdefault('vocab_size', 128)
    kw.setdefault('hidden_size', 64)
    kw.setdefault('num_layers', 4)
    kw.setdefault('num_heads', 4)
    kw.setdefault('max_seq_len', 128)
    kw.setdefault('dropout', 0.0)
    return BertForPretraining(BertConfig(**kw), device=device, seed=seed)


def bert_base(device=None, seed=0, **kw):
    """BERT-base (110M): vocab 30522, hidden 768, 12 layers, 12 heads,
    dropout 0.1 (Devlin et al. 2018)."""
    return BertForPretraining(BertConfig(**kw), device=device, seed=seed)


def bert_large(device=None, seed=0, **kw):
    """BERT-large (340M): hidden 1024, 24 layers, 16 heads."""
    kw.setdefault('hidden_size', 1024)
    kw.setdefault('num_layers', 24)
    kw.setdefault('num_heads', 16)
    return BertForPretraining(BertConfig(**kw), device=device, seed=seed)
