"""Transformer layers (counterpart of ``paddle_tpu/nn/layer/transformer.py``):
``MultiHeadAttention`` with its ``Cache`` / ``StaticCache``, the encoder
and decoder layers and stacks, and ``Transformer``.

Attention is the reference's: scores ``q k^T / sqrt(Dh)``, plus the
mask (a bool mask becomes 0 where True and -1e9 elsewhere, a float mask
is added as it is, both in the scores' dtype), ``torch.softmax`` over
the keys, dropout on the weights, then ``weights @ v``.  Like the
reference's ``jax.nn.softmax`` it reaches no hand-written kernel (no
fused softmax, no flash attention), and under AMP it runs as the gray
op ``multihead_attention``: in bf16 under O2, the softmax too.  The
LayerNorms go through ``F.layer_norm``, the LayerNorm kernel on the
card.

Incremental decoding: ``Cache`` holds the projected keys and values of
every earlier position ``[B, H, L_past, Dh]`` and each cached forward
appends the new step's (``cache_concat``); ``StaticCache`` holds them
once over the encoder's memory for cross attention.  ``gen_cache``
builds either, as the reference's.
"""
import collections
import copy
import math

import torch
from torch.profiler import record_function

from ...amp import amp_cast
from ...core.device import resolve_device
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .layers import Layer
from .norm import LayerNorm

__all__ = ['MultiHeadAttention', 'TransformerEncoderLayer',
           'TransformerEncoder', 'TransformerDecoderLayer',
           'TransformerDecoder', 'Transformer']


def _convert_attn_mask(mask, dtype):
    if mask is None:
        return None
    if mask.dtype == torch.bool:
        zero = torch.zeros((), dtype=dtype, device=mask.device)
        neg = torch.full((), -1e9, dtype=dtype, device=mask.device)
        return torch.where(mask, zero, neg)
    return mask.to(dtype)


class MultiHeadAttention(Layer):
    """Attention over ``num_heads`` heads of ``embed_dim // num_heads``;
    ``forward(query, key=None, value=None, attn_mask=None, cache=None)``
    returns the output (and the weights with ``need_weights``, and the
    new cache with ``cache``)."""

    Cache = collections.namedtuple('Cache', ['k', 'v'])
    StaticCache = collections.namedtuple('StaticCache', ['k', 'v'])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _split_heads(self, t):
        """``[B, L, E]`` -> ``[B, H, L, Dh]``."""
        t, = amp_cast('split_heads', t)
        B, L, _ = t.shape
        return t.reshape(B, L, self.num_heads, self.head_dim).transpose(1, 2)

    def compute_kv(self, key, value):
        """The projected, head-split keys and values
        (``[B, H, L, Dh]`` each)."""
        return (self._split_heads(self.k_proj(key)),
                self._split_heads(self.v_proj(value)))

    def gen_cache(self, key, value=None, type=None):
        """``StaticCache`` of ``(key, value)``'s projections, or a
        ``Cache``: empty ``[B, H, 0, Dh]`` buffers when ``value`` is
        None, else ``(key, value)`` as they are."""
        if type is None:
            type = MultiHeadAttention.Cache
        if type == MultiHeadAttention.StaticCache:
            return self.StaticCache(*self.compute_kv(key, value))
        if value is None:
            empty = torch.zeros((key.shape[0], self.num_heads, 0,
                                 self.head_dim), dtype=key.dtype,
                                device=key.device)
            return self.Cache(empty, empty)
        return self.Cache(key, value)

    def _attend(self, qh, kh, vh, attn_mask, op_name):
        """``[B, H, Lq, Dh]`` heads -> ``[B, Lq, E]`` (and the
        weights), inside a ``multihead_attention`` range (a profile's
        attention time)."""
        with record_function('multihead_attention'):
            return self._attend_body(qh, kh, vh, attn_mask, op_name)

    def _attend_body(self, qh, kh, vh, attn_mask, op_name):
        qh, kh, vh = amp_cast(op_name, qh, kh, vh)
        B, _, Lq, _ = qh.shape
        scores = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(
            self.head_dim)
        m = _convert_attn_mask(attn_mask, scores.dtype)
        if m is not None:
            scores = scores + m
        weights = torch.softmax(scores, dim=-1)
        p = weights
        if self.training and self.dropout > 0:
            p = F.dropout(p, self.dropout, training=True)
        out = torch.matmul(p, vh).transpose(1, 2).reshape(
            B, Lq, self.num_heads * self.head_dim)
        return out, weights

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        if cache is None:
            qh = self._split_heads(self.q_proj(query))
            kh, vh = self.compute_kv(key, value)
            ctx, weights = self._attend(qh, kh, vh, attn_mask,
                                        'multihead_attention')
            out = self.out_proj(ctx)
            return (out, weights) if self.need_weights else out
        qh = self._split_heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            kh, vh = cache.k, cache.v
        else:
            kh, vh = self.compute_kv(key, value)
        if isinstance(cache, self.Cache):
            ck, kh, cv, vh = amp_cast('cache_concat', cache.k, kh,
                                      cache.v, vh)
            kh = torch.cat([ck, kh], dim=2)
            vh = torch.cat([cv, vh], dim=2)
            cache = self.Cache(kh, vh)
        ctx, weights = self._attend(qh, kh, vh, attn_mask,
                                    'multihead_attention_cached')
        out = self.out_proj(ctx)
        if self.need_weights:
            return out, weights, cache
        return out, cache


class TransformerEncoderLayer(Layer):
    """Self-attention and a two-layer FFN, each with a residual and a
    LayerNorm, post-norm unless ``normalize_before``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation='relu', attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, incremental_cache = self.self_attn(src, src, src,
                                                    src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.act_dropout(self.activation(
            self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, incremental_cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src, type=self.self_attn.Cache)


class TransformerEncoder(Layer):
    """``num_layers`` copies of ``encoder_layer`` (the first is the layer
    itself), then ``norm`` if given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer] +
            [copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        out = src
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                out = layer(out, src_mask)
            else:
                out, new_cache = layer(out, src_mask, cache=cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            out = self.norm(out)
        return out if cache is None else (out, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    """Self-attention, cross-attention over the memory and a two-layer
    FFN, each with a residual and a LayerNorm."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation='relu', attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt,
                                                    tgt_mask, cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt, static_cache = self.cross_attn(tgt, memory, memory,
                                                memory_mask, cache[1])
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.act_dropout(self.activation(
            self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental_cache,
                                                static_cache))

    def gen_cache(self, memory):
        """``(Cache, StaticCache)``: an empty self-attention cache and the
        cross-attention keys and values over ``memory``."""
        incremental_cache = self.self_attn.gen_cache(
            memory, type=self.self_attn.Cache)
        static_cache = self.cross_attn.gen_cache(
            memory, memory, type=self.cross_attn.StaticCache)
        return incremental_cache, static_cache


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer] +
            [copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        out = tgt
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                out = layer(out, memory, tgt_mask, memory_mask)
            else:
                out, new_cache = layer(out, memory, tgt_mask, memory_mask,
                                       cache=cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            out = self.norm(out)
        return out if cache is None else (out, new_caches)

    def gen_cache(self, memory, do_zip=False):
        """Per-layer ``(Cache, StaticCache)`` pairs; ``do_zip`` gives
        ``([caches], [static caches])``."""
        cache = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            cache = list(zip(*cache))
        return cache


class Transformer(Layer):
    """Encoder-decoder at the defaults of Transformer-base (d_model 512,
    8 heads, 6 + 6 layers, FFN 2048, dropout 0.1); a final LayerNorm on
    each stack only with ``normalize_before``."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation='relu', attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            enc_norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            dec_norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """``[length, length]`` f32: 0 on and below the diagonal, -1e9
        above, on ``device`` (the default device when None)."""
        ones = torch.ones(length, length, dtype=torch.bool,
                          device=resolve_device(device))
        return torch.where(torch.tril(ones),
                           torch.zeros((), device=ones.device),
                           torch.full((), -1e9, device=ones.device))
