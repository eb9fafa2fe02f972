"""GPT causal LM (counterpart of ``paddle_tpu/models/gpt.py``).

Serving: the cached forward that decoding and the serving engine run,
the dense-cache attention branch (prompt prefill and ``generate``) and
the paged branch (the engine's batched decode), ``prefill``/
``decode_step``/``generate`` (one CUDA graph per signature on the
card).  Training: the uncached ``forward(ids)``,
whose attention is flash attention (the hand-written CUDA forward and
backward kernels of ``ops/flash_attention.py``) while attention dropout
is inactive, and otherwise the reference's plain branch (scores, the
causal ``-1e9`` mask, ``F.softmax`` through the hand-written softmax
kernel of ``ops/fused_softmax.py``, dropout, the product with v); and
``loss`` with and without the fused CE head (``ops/fused_ce.py``).
The reference's dropouts are all here (embedding, attention
probabilities, attention output, MLP output), drawing from the device's
generator (``core.rng``); the serving paths run in eval mode, where
they are the identity.  Every LayerNorm runs the hand-written CUDA
LayerNorm kernel (``ops/fused_norm.py``), each MLP's fc+GELU goes
through ``mlp_gelu`` (``ops/fused_gelu_linear.py``).  Ops the reference
dispatches by name cast their inputs through the AMP policy
(``amp.amp_cast``), under the same names.

MoE, sequence parallelism and striped sp wait for their slices.
"""
import functools
import math

import torch
from torch import nn

from ..amp import amp_cast
from ..core.compile_cache import GraphCache, bucket_pow2
from ..core.device import resolve_device
from ..distributed.fleet.meta_parallel import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
from ..nn import functional as F
from ..nn.layer.common import Dropout, Embedding
from ..nn.layer.norm import LayerNorm
from ..ops.flash_attention import can_use_pallas, flash_attention
from ..ops.fused_ce import fused_linear_cross_entropy
from ..ops.fused_gelu_linear import mlp_gelu
from ..ops.paged_attention import paged_attention, write_kv
from ..ops.sampling import sample_rows

__all__ = ['GPTConfig', 'GPT', 'GPTForCausalLM', 'gpt_tiny', 'gpt_small']


class GPTConfig:
    """The reference ``GPTConfig``'s single-device fields, with the same
    defaults.  The multi-chip fields (sequence parallel, MoE, striped
    sp, scan decode) come with the slices that use them.

    ``fused_head``: the training forward returns the final hidden
    states and ``loss`` fuses the tied head matmul with the softmax CE
    (``ops/fused_ce.py``), chunked over the vocab in
    ``fused_head_chunks`` chunks.  ``initializer_range`` is kept for
    parity; the reference's init does not read it either."""

    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, max_seq_len=1024, intermediate_size=None,
                 dropout=0.1, layer_norm_epsilon=1e-5,
                 initializer_range=0.02, fused_head=False,
                 fused_head_chunks=8):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_seq_len = max_seq_len
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.dropout = dropout
        self.layer_norm_epsilon = layer_norm_epsilon
        self.initializer_range = initializer_range
        self.fused_head = fused_head
        self.fused_head_chunks = fused_head_chunks


def _cached_attention(q, kb, vb, p):
    """The reference's dense cached attention (``gpt.py:230-238``):
    queries at absolute positions ``p .. p+T-1`` over the whole
    ``[B, nh, Tmax, hd]`` buffer, causal ``-1e9`` mask."""
    T = q.shape[2]
    Tmax = kb.shape[2]
    hd = q.shape[-1]
    scores = torch.matmul(q, kb.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    row = p + torch.arange(T, device=q.device)
    col = torch.arange(Tmax, device=q.device)
    mask = col[None, :] <= row[:, None]
    scores = torch.where(mask[None, None], scores,
                         torch.full((), -1e9, dtype=scores.dtype,
                                    device=scores.device))
    att = torch.softmax(scores, dim=-1)
    return torch.matmul(att, vb)


class CausalSelfAttention(nn.Module):
    """Multi-head causal attention over a dense or a paged KV cache."""

    def __init__(self, cfg, device=None):
        super().__init__()
        if cfg.hidden_size % cfg.num_heads:
            raise ValueError('hidden_size must be a multiple of num_heads')
        self.n_head = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.qkv = ColumnParallelLinear(cfg.hidden_size,
                                        3 * cfg.hidden_size,
                                        gather_output=False, device=device)
        self.proj = RowParallelLinear(cfg.hidden_size, cfg.hidden_size,
                                      input_is_parallel=True, device=device)
        self.attn_drop = Dropout(cfg.dropout)
        self.resid_drop = Dropout(cfg.dropout)

    def _use_flash(self, T):
        """Flash attention unless attention dropout is active
        (training mode) or the head dim is not the kernels'."""
        dropout_active = self.training and self.attn_drop.p > 0.0
        return not dropout_active and can_use_pallas(T, T, self.head_dim)

    def _uncached(self, q, k, v):
        """Uncached causal attention, ``[B, nh, T, hd]`` in and out:
        the flash kernels, or the reference's plain branch."""
        B, nh, T, hd = q.shape
        if self._use_flash(T):
            q, k, v = amp_cast('flash_attention', q, k, v)
            y = flash_attention(q.reshape(B * nh, T, hd),
                                k.reshape(B * nh, T, hd),
                                v.reshape(B * nh, T, hd), causal=True)
            return y.reshape(B, nh, T, hd)
        q, k = amp_cast('matmul', q, k)
        att = torch.matmul(q, k.transpose(-1, -2))
        att, = amp_cast('multiply', att)
        att = att * (1.0 / math.sqrt(hd))
        att, = amp_cast('subtract', att)
        mask = torch.ones((T, T), dtype=att.dtype, device=att.device).tril()
        att = att - (1.0 - mask) * 1e9
        att = F.softmax(att, axis=-1)
        att = self.attn_drop(att)
        att, v = amp_cast('matmul', att, v)
        return torch.matmul(att, v)

    def forward(self, x, cache=None, pos=None):
        B, T, H = x.shape
        qkv = self.qkv(x).reshape(B, T, 3, self.n_head, self.head_dim)
        q = qkv[:, :, 0].transpose(1, 2)             # [B, nh, T, hd]
        k = qkv[:, :, 1].transpose(1, 2)
        v = qkv[:, :, 2].transpose(1, 2)
        if cache is None:
            y = self._uncached(q, k, v)
            new_cache = None
        elif getattr(cache, 'paged', False):
            # serving decode: one token per sequence, k/v written into
            # the pool through the block table, ragged length masking
            if T != 1:
                raise ValueError(
                    'paged cache views decode one token per step; '
                    f'prefill goes through the dense path (got T={T})')
            write_kv(cache.k_pool, cache.v_pool, k[:, :, 0], v[:, :, 0],
                     cache.block_table, cache.slots)
            y = paged_attention(q[:, :, 0], cache.k_pool, cache.v_pool,
                                cache.block_table, cache.lens)[:, :, None]
            new_cache = cache
        else:
            # dense buffers [B, nh, Tmax, hd], written in place at the
            # absolute offset `pos` (the reference's
            # dynamic_update_slice; the caller owns the buffers): an
            # int, or a 0-d device tensor that stays on the device
            kb, vb = cache
            if torch.is_tensor(pos):
                p = pos.to(device=kb.device, dtype=torch.int64)
                slots = p + torch.arange(T, device=kb.device)
                kb.index_copy_(2, slots, k.to(kb.dtype))
                vb.index_copy_(2, slots, v.to(vb.dtype))
            else:
                p = int(pos)
                kb[:, :, p:p + T] = k.to(kb.dtype)
                vb[:, :, p:p + T] = v.to(vb.dtype)
            y = _cached_attention(q, kb, vb, p)
            new_cache = (kb, vb)
        y = y.transpose(1, 2).reshape(B, T, H)
        return self.resid_drop(self.proj(y)), new_cache


class GPTMLP(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.fc = ColumnParallelLinear(cfg.hidden_size,
                                       cfg.intermediate_size,
                                       gather_output=False, device=device)
        self.proj = RowParallelLinear(cfg.intermediate_size,
                                      cfg.hidden_size,
                                      input_is_parallel=True, device=device)
        self.drop = Dropout(cfg.dropout)

    def forward(self, x):
        return self.drop(self.proj(mlp_gelu(x, self.fc)))


class GPTBlock(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln1 = LayerNorm(cfg.hidden_size,
                             epsilon=cfg.layer_norm_epsilon, device=device)
        self.attn = CausalSelfAttention(cfg, device=device)
        self.ln2 = LayerNorm(cfg.hidden_size,
                             epsilon=cfg.layer_norm_epsilon, device=device)
        self.mlp = GPTMLP(cfg, device=device)

    def forward(self, x, cache=None, pos=None):
        a, new_cache = self.attn(self.ln1(x), cache=cache, pos=pos)
        x = _add(x, a)
        x = _add(x, self.mlp(self.ln2(x)))
        return x, new_cache


def _add(a, b):
    """``a + b`` as the reference's gray ``add`` op under AMP (O1: both
    low when either is; O2: both low)."""
    a, b = amp_cast('add', a, b)
    return a + b


class GPT(nn.Module):
    """Backbone: embeddings + blocks + final LN -> hidden states."""

    def __init__(self, config, device=None):
        super().__init__()
        self.config = config
        self.wte = VocabParallelEmbedding(config.vocab_size,
                                          config.hidden_size, device=device)
        self.wpe = Embedding(config.max_seq_len, config.hidden_size,
                             device=device)
        self.drop = Dropout(config.dropout)
        self.blocks = nn.ModuleList([GPTBlock(config, device=device)
                                     for _ in range(config.num_layers)])
        self.ln_f = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_epsilon,
                              device=device)

    def forward(self, input_ids, caches=None, pos=None):
        T = input_ids.shape[1]
        if caches is None:
            # training path: position rows 0..T-1, flash attention
            if T > self.config.max_seq_len:
                raise ValueError(f'sequence length {T} exceeds '
                                 f'max_seq_len {self.config.max_seq_len}')
            x = self.drop(_add(self.wte(input_ids),
                               F.embedding_prefix(self.wpe.weight, T)))
            for blk in self.blocks:
                x, _ = blk(x)
            return self.ln_f(x)
        steps = torch.arange(T, device=input_ids.device)
        if torch.is_tensor(pos) and pos.dim() == 1:
            # the serving engine's ragged live set: a [B] start vector
            posv = pos.long()[:, None] + steps[None, :]
        elif torch.is_tensor(pos):
            # one start on the device (generate's captured steps)
            posv = pos.long() + steps
        else:
            posv = int(pos) + steps
        x = self.drop(_add(self.wte(input_ids), self.wpe(posv)))
        new_caches = []
        for blk, c in zip(self.blocks, caches):
            x, nc = blk(x, cache=c, pos=pos)
            new_caches.append(nc)
        return self.ln_f(x), new_caches


class GPTForCausalLM(nn.Module):
    """GPT + tied LM head; ``forward`` returns logits (or, training with
    ``fused_head``, hidden states), ``loss`` the causal LM loss.

    ``device=None`` is the CUDA card (raises without one); ``seed``
    draws the random init from an explicit CPU ``torch.Generator``, so
    the same seed gives the same weights on every device.  The model is
    built in eval mode (serving); a trainer switches it to train()."""

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        self.device = resolve_device(device)
        self.config = config
        self.gpt = GPT(config, device=self.device)
        self.init_weights(torch.Generator().manual_seed(int(seed)))
        self.eval()
        # generate's modules, one per signature; its graphs share a pool
        self._gen_cache = GraphCache(self.device, shared_pool=True)

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

    def _head(self, h):
        h, w = amp_cast('matmul', h, self.gpt.wte.weight)
        return torch.matmul(h, w.t())

    def forward(self, input_ids, caches=None, pos=None):
        if caches is not None:
            h, new_caches = self.gpt(input_ids, caches=caches, pos=pos)
            return self._head(h), new_caches
        h = self.gpt(input_ids)
        if self.config.fused_head and self.training:
            # the head matmul happens inside loss() (ops/fused_ce.py)
            return h
        return self._head(h)

    def loss(self, logits, labels, aux_losses=None):
        """Causal LM loss: shift-by-one cross entropy, mean over the
        ``B * (T - 1)`` predicted tokens.

        With ``config.fused_head``, a training forward returns hidden
        states ``[B, T, H]`` and the tied head, softmax and CE fuse
        here (``ops/fused_ce.py``, a gray op under AMP); the branch is
        keyed off the shape the forward produced, as in the reference.
        ``aux_losses`` (MoE) is not ported."""
        if aux_losses:
            raise NotImplementedError('MoE auxiliary losses are not '
                                      'ported yet')
        cfg = self.config
        B, T, D = logits.shape
        labels = torch.as_tensor(labels, device=logits.device)
        if cfg.fused_head and D == cfg.hidden_size and D != cfg.vocab_size:
            h, w = amp_cast('fused_lm_head_ce', logits, self.gpt.wte.weight)
            losses = fused_linear_cross_entropy(
                h[:, :-1, :].reshape(B * (T - 1), D), w.t(),
                labels[:, 1:].reshape(B * (T - 1)),
                num_chunks=cfg.fused_head_chunks)
            return losses.mean()
        return F.cross_entropy(logits[:, :-1, :].reshape(B * (T - 1), D),
                               labels[:, 1:].reshape(B * (T - 1)))

    def init_decode_caches(self, batch_size, max_len):
        """Per-layer dense f32 KV buffers ``[B, nh, max_len, hd]``."""
        cfg = self.config
        nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        shape = (int(batch_size), nh, int(max_len), hd)
        return [(torch.zeros(shape, device=self.device),
                 torch.zeros(shape, device=self.device))
                for _ in range(cfg.num_layers)]

    @torch.no_grad()
    def prefill(self, ids, pos, caches):
        """Cached forward over a (padded) prompt: every position's k/v
        lands in ``caches`` starting at ``pos``; returns ``(logits,
        new_caches)``.  ``caches`` are dense buffers
        (``init_decode_caches``) or paged views (decode only); ``pos``
        is an int or a ``[B]`` tensor of absolute start positions."""
        return self(ids, caches=caches, pos=pos)

    def decode_step(self, tok, pos, caches):
        """One incremental decode step: ``tok [B, 1]`` at absolute
        position(s) ``pos``.  The same cached forward as ``prefill``."""
        return self.prefill(tok, pos, caches)

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens, temperature=1.0,
                 top_k=None, seed=0):
        """Autoregressive decode over the dense cache, one module per
        signature, as the reference compiles one XLA module.

        The prompt is right-padded to its pow2 bucket P (capped so
        bucket plus new tokens fit ``max_seq_len``), prefilled once,
        sampled at row ``T0-1``, then one decode step per new token;
        padded k/v slots are overwritten before the causal mask exposes
        them.  temperature 0 is greedy.  Returns ``[B, T0 +
        max_new_tokens]``.

        Modules are keyed as the reference keys them, ``(B, P,
        max_new_tokens, greedy, temperature, top_k)``; the padded ids,
        the true length T0 and the seed are the module's inputs, so any
        prompt length inside a bucket and any seed reuse it.  On the
        card the module is one CUDA graph of the whole call (the
        prefill and every decode step, positions and seed on the
        device, no host read between tokens), captured at the
        signature's first call (``core.compile_cache``); on the CPU it
        is the same body, run eagerly.
        """
        cfg = self.config
        ids = torch.as_tensor(input_ids, dtype=torch.int64) \
            .to(self.device)
        B, T0 = ids.shape
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 1:
            return ids
        if T0 + max_new_tokens > cfg.max_seq_len:
            raise ValueError(
                f'prompt+new tokens {T0 + max_new_tokens} exceeds '
                f'max_seq_len {cfg.max_seq_len}')
        P = self._decode_bucket(T0, max_new_tokens)
        greedy = temperature == 0 or temperature is None
        sig = (B, P, max_new_tokens, greedy, float(temperature or 0.0),
               top_k)
        module = self._gen_cache.module(sig, functools.partial(
            self._generate_body, max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k))
        new = module(torch.nn.functional.pad(ids, (0, P - T0)),
                     torch.tensor(T0, dtype=torch.int64),
                     torch.tensor(int(seed), dtype=torch.int64))
        return torch.cat([ids, new], dim=1)

    def _generate_body(self, ids_p, t0, seed, max_new_tokens, temperature,
                       top_k):
        """``generate``'s module: padded ids ``[B, P]``, the true length
        ``t0`` and ``seed`` (0-d int64 tensors) -> the new tokens ``[B,
        max_new_tokens]``, on device tensors only."""
        B, P = ids_p.shape
        caches = self.init_decode_caches(B, P + max_new_tokens)
        logits, caches = self.prefill(ids_p, 0, caches)
        # every sampled position: t0-1 (the prefill's last true row),
        # then each decode step's input slot t0 .. t0+N-2
        positions = t0 - 1 + torch.arange(max_new_tokens, device=t0.device)
        pos = positions[0]
        tok = sample_rows(logits.index_select(1, pos.reshape(1))[:, 0],
                          seed, pos, temperature, top_k)
        out = [tok]
        for i in range(1, max_new_tokens):
            pos = positions[i]
            logits, caches = self.decode_step(tok[:, None], pos, caches)
            tok = sample_rows(logits[:, -1], seed, pos, temperature, top_k)
            out.append(tok)
        return torch.stack(out, dim=1)

    def _decode_bucket(self, T0, max_new_tokens):
        """Prompt bucket: next power of two, capped so bucket + new
        tokens fit ``max_seq_len``."""
        return bucket_pow2(T0, cap=self.config.max_seq_len - max_new_tokens)


def gpt_tiny(device=None, seed=0, **kw):
    """4-layer toy config for tests."""
    kw.setdefault('vocab_size', 128)
    kw.setdefault('hidden_size', 64)
    kw.setdefault('num_layers', 4)
    kw.setdefault('num_heads', 4)
    kw.setdefault('max_seq_len', 128)
    kw.setdefault('dropout', 0.0)
    return GPTForCausalLM(GPTConfig(**kw), device=device, seed=seed)


def gpt_small(device=None, seed=0, **kw):
    """GPT-2 small (117M)."""
    kw.setdefault('hidden_size', 768)
    kw.setdefault('num_layers', 12)
    kw.setdefault('num_heads', 12)
    return GPTForCausalLM(GPTConfig(**kw), device=device, seed=seed)
