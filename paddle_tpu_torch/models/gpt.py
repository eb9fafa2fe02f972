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

MoE: with ``moe_num_experts > 0`` every ``moe_every``-th block's MLP is
a ``SwitchMoE`` (``incubate/moe.py``), ``loss`` adds the mean of the
blocks' load-balance terms times ``moe_aux_weight``, and ``generate``
does not pad the prompt (padded rows would take expert capacity).
Tensor parallelism (the mesh's ``tp`` axis, ``fleet.init`` with
``mp_degree``): the layers are ``fleet.meta_parallel``'s, each rank
holding its shard, so attention runs ``num_heads / tp`` local heads
(the fused qkv keeps whole heads, ``groups=3``), the tied head's input
crosses ``copy_to_region`` (its gradient all-reduced) and the loss is
the vocab-parallel cross entropy, fused (``fused_linear_cross_entropy_
tp``) or not (``parallel_cross_entropy``).  Attention-probability
dropout draws from the ``model_parallel`` stream there (other masks on
each rank's heads); the other dropouts act on replicated activations
and draw the same masks on every ``tp`` rank.  The cached (serving)
forward under tensor parallelism, and sequence parallelism, are not
ported yet (ROADMAP items 9b's second part and 9c).
"""
import functools
import math

import torch
from torch import nn

from ..amp import amp_cast
from ..core.compile_cache import GraphCache, bucket_pow2
from ..core.device import resolve_device
from ..distributed import env as _env
from ..distributed.fleet.meta_parallel import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    copy_to_region, get_rng_state_tracker, parallel_cross_entropy,
    tp_state)
from ..incubate.moe import SwitchMoE
from ..nn import functional as F
from ..nn.layer.common import Dropout, Embedding
from ..nn.layer.layers import deferred_init
from ..nn.layer.norm import LayerNorm
from ..ops.flash_attention import can_use_pallas, flash_attention
from ..ops.fused_ce import (fused_linear_cross_entropy,
                            fused_linear_cross_entropy_tp)
from ..ops.fused_gelu_linear import mlp_gelu
from ..ops.paged_attention import paged_attention, write_kv
from ..ops.sampling import sample_rows

__all__ = ['GPTConfig', 'GPT', 'GPTForCausalLM', 'gpt_tiny', 'gpt_small',
           'gpt_1p3b', 'gpt_moe_tiny']


class GPTConfig:
    """The reference ``GPTConfig``: its fields and defaults.

    ``fused_head``: the training forward returns the final hidden
    states and ``loss`` fuses the tied head matmul with the softmax CE
    (``ops/fused_ce.py``), chunked over the vocab in
    ``fused_head_chunks`` chunks.  ``moe_*``: routed experts
    (``SwitchMoE``) on every ``moe_every``-th block when
    ``moe_num_experts > 0``, and the load-balance term's weight in the
    loss.  ``sequence_parallel`` and ``striped_sp`` are sequence
    parallelism (ROADMAP Queue 1 item 9c) and raise when set; ``scan_decode_blocks`` is the
    reference's compile-time lever with token-exact results, which the
    port has no use for; ``initializer_range`` is read by neither
    package's init."""

    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, max_seq_len=1024, intermediate_size=None,
                 dropout=0.1, layer_norm_epsilon=1e-5,
                 sequence_parallel=False, initializer_range=0.02,
                 moe_num_experts=0, moe_every=2, moe_top_k=1,
                 moe_capacity_factor=1.25, moe_aux_weight=0.01,
                 fused_head=False, fused_head_chunks=8,
                 striped_sp=False, scan_decode_blocks=False):
        for field, value in (('sequence_parallel', sequence_parallel),
                             ('striped_sp', striped_sp)):
            if value:
                raise NotImplementedError(
                    f'GPTConfig({field}=True): {_env.ITEM_9C}')
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_seq_len = max_seq_len
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.dropout = dropout
        self.layer_norm_epsilon = layer_norm_epsilon
        self.initializer_range = initializer_range
        self.sequence_parallel = sequence_parallel
        self.moe_num_experts = moe_num_experts
        self.moe_every = moe_every
        self.moe_top_k = moe_top_k
        self.moe_capacity_factor = moe_capacity_factor
        self.moe_aux_weight = moe_aux_weight
        self.fused_head = fused_head
        self.fused_head_chunks = fused_head_chunks
        self.striped_sp = striped_sp
        self.scan_decode_blocks = scan_decode_blocks


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


def local_heads(num_heads):
    """The heads this rank's attention holds: ``num_heads / tp``."""
    tp = tp_state()[1]
    if num_heads % tp:
        raise ValueError(f'num_heads {num_heads} does not divide over '
                         f'tp {tp}')
    return num_heads // tp


def tp_dropout(drop, x, group):
    """``drop(x)`` for an activation sharded over ``tp`` (local heads):
    from the ``model_parallel`` stream where there is a ``tp`` group."""
    if group is None:
        return drop(x)
    with get_rng_state_tracker().rng_state('model_parallel'):
        return drop(x)


class CausalSelfAttention(nn.Module):
    """Multi-head causal attention over a dense or a paged KV cache."""

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
        att = tp_dropout(self.attn_drop, att, self._tp_group)
        att, v = amp_cast('matmul', att, v)
        return torch.matmul(att, v)

    def forward(self, x, cache=None, pos=None):
        B, T, H = x.shape
        if cache is not None and self._tp_group is not None:
            raise NotImplementedError(
                f'the cached (serving) forward under tensor parallelism: '
                f'{_env.ITEM_9B}')
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
        y = y.transpose(1, 2).reshape(B, T, self.n_head * self.head_dim)
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
    def __init__(self, cfg, use_moe=False, device=None):
        super().__init__()
        self.ln1 = LayerNorm(cfg.hidden_size,
                             epsilon=cfg.layer_norm_epsilon, device=device)
        self.attn = CausalSelfAttention(cfg, device=device)
        self.ln2 = LayerNorm(cfg.hidden_size,
                             epsilon=cfg.layer_norm_epsilon, device=device)
        if use_moe:
            self.mlp = SwitchMoE(cfg.hidden_size, cfg.intermediate_size,
                                 cfg.moe_num_experts, top_k=cfg.moe_top_k,
                                 capacity_factor=cfg.moe_capacity_factor,
                                 device=device)
        else:
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


def _f32(value, device):
    """A 0-d f32 tensor: CUDA divides by a Python number through its
    rounded reciprocal, one ulp off the CPU's quotient."""
    return torch.full((), value, dtype=torch.float32, device=device)


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
        self.blocks = nn.ModuleList([
            GPTBlock(config, use_moe=(
                config.moe_num_experts > 0
                and i % config.moe_every == config.moe_every - 1),
                device=device)
            for i in range(config.num_layers)])
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
        with deferred_init():       # init_weights draws every parameter
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
        """The tied head: this rank's vocab columns under ``tp``."""
        h = copy_to_region(h, self.gpt.wte._tp_group)
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

        A MoE model adds ``moe_aux_weight`` times the mean of the
        blocks' load-balance terms: ``aux_losses`` where given, else
        each ``SwitchMoE``'s ``.aux_loss`` from the forward that made
        ``logits``.  The sum, mean, product and the add to the CE run
        in f32 under every AMP policy: the reference's AMP casts them
        to the low dtype, but its trainer compiles the loss with XLA,
        which drops those round trips (excess precision), so its losses
        are not rounded to bf16."""
        out = self._lm_loss(logits, labels)
        if self.config.moe_num_experts <= 0:
            return out
        if aux_losses is not None:
            aux = list(aux_losses)
        else:
            aux = [blk.mlp.aux_loss for blk in self.gpt.blocks
                   if getattr(blk.mlp, 'aux_loss', None) is not None]
        if not aux:
            return out
        total = aux[0].float()
        for a in aux[1:]:
            total = total + a.float()
        total = total / _f32(len(aux), total.device)
        return out.float() + _f32(self.config.moe_aux_weight,
                                  total.device) * total

    def _lm_loss(self, logits, labels):
        cfg = self.config
        B, T, D = logits.shape
        labels = torch.as_tensor(labels, device=logits.device)
        wte = self.gpt.wte
        group = wte._tp_group
        if cfg.fused_head and D == cfg.hidden_size and \
                D != wte.num_embeddings:
            h, w = amp_cast('fused_lm_head_ce', logits, wte.weight)
            args = (h[:, :-1, :].reshape(B * (T - 1), D), w.t(),
                    labels[:, 1:].reshape(B * (T - 1)))
            if group is not None:
                return fused_linear_cross_entropy_tp(
                    *args, group=group,
                    num_chunks=cfg.fused_head_chunks).mean()
            losses = fused_linear_cross_entropy(
                *args, num_chunks=cfg.fused_head_chunks)
            return losses.mean()
        if group is not None:
            return parallel_cross_entropy(
                logits[:, :-1, :].reshape(B * (T - 1), D),
                labels[:, 1:].reshape(B * (T - 1)), group,
                wte.vocab_start).mean()
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
        tokens fit ``max_seq_len``; a MoE model's is ``T0`` itself
        (padded rows would compete for expert capacity in prefill)."""
        if self.config.moe_num_experts > 0:
            return T0
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


def gpt_moe_tiny(device=None, seed=0, **kw):
    """gpt_tiny with routed experts on alternating blocks."""
    kw.setdefault('moe_num_experts', 4)
    kw.setdefault('moe_top_k', 1)
    return gpt_tiny(device=device, seed=seed, **kw)


def gpt_1p3b(device=None, seed=0, **kw):
    """GPT-3 XL-ish 1.3B, the reference's hybrid-parallel config."""
    kw.setdefault('hidden_size', 2048)
    kw.setdefault('num_layers', 24)
    kw.setdefault('num_heads', 16)
    kw.setdefault('max_seq_len', 2048)
    return GPTForCausalLM(GPTConfig(**kw), device=device, seed=seed)
