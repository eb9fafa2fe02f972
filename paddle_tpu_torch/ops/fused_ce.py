"""Fused linear + softmax cross-entropy head (counterpart of
``paddle_tpu/ops/fused_ce.py``).

The LM-head matmul is fused into the loss: the vocab axis is taken in
``num_chunks`` column chunks with an online logsumexp,

    m' = max(m, max_j z_j)       s' = s e^(m - m') + sum_j e^(z_j - m')

plus a label-logit gather, so live memory is one ``[N, V/num_chunks]``
chunk and the ``[N, V]`` logits never exist.  The backward recomputes
each chunk's logits and emits ``dx`` and ``dw`` chunk by chunk.  The
reference is plain jnp, so this is plain PyTorch: the chunk products
are ``torch.mm``.

Chunks are column slices of ``w``; the last one is narrower when
``V % num_chunks != 0`` (the reference pads ``w`` and masks the padded
columns to -inf instead: the same sums).

Precision, as the reference: a chunk's logits are f32 (bf16 operands
accumulate in f32 and the product is not rounded to bf16); the
backward's products take the operands in the inputs' dtype with f32
accumulation (for f32 inputs these are f32 products, the reference's
f32 dots; for bf16 inputs the f32 cotangent is rounded to bf16 first,
which is what the reference's f32 dots do on the TPU at XLA's default
one-pass bf16 precision).  ``dx`` and ``dw`` come back in the inputs'
dtypes.

``fused_linear_cross_entropy_tp`` (vocab-parallel) waits for the
distributed slice.
"""
import torch

from ..core.autograd import composed_backward

__all__ = ['fused_linear_cross_entropy']


def _chunks(V, num_chunks):
    """Column ranges ``(c0, c1)`` of the chunks, empty ones dropped."""
    vc = -(-V // int(num_chunks))
    return [(c0, min(c0 + vc, V)) for c0 in range(0, V, vc)]


def _mm(a, b, dtype):
    """``a @ b`` with operands in ``dtype`` and an f32 result."""
    a, b = a.to(dtype), b.to(dtype)
    if dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    # bf16 x bf16 products are exact in f32: the f32 product of the
    # widened operands is the same sum
    return torch.mm(a.float(), b.float())


def _owned(labels, c0, c1):
    loc = labels - c0
    return loc, (loc >= 0) & (loc < c1 - c0)


def _forward(x, w, labels, num_chunks):
    """Per-row ``(lse, label logit)`` by the online logsumexp."""
    n = x.shape[0]
    m = torch.full((n,), float('-inf'), device=x.device)
    s = torch.zeros((n,), device=x.device)
    zl = torch.zeros((n,), device=x.device)
    for c0, c1 in _chunks(w.shape[1], num_chunks):
        z = _mm(x, w[:, c0:c1], x.dtype)                     # [N, Vc] f32
        new_m = torch.maximum(m, z.amax(dim=-1))
        s = s * torch.exp(m - new_m) \
            + torch.exp(z - new_m[:, None]).sum(dim=-1)
        m = new_m
        loc, mine = _owned(labels, c0, c1)
        picked = z.gather(1, loc.clamp(0, c1 - c0 - 1)[:, None])[:, 0]
        zl = zl + torch.where(mine, picked, torch.zeros_like(picked))
    return torch.log(s) + m, zl


def _backward(x, w, labels, lse, g, num_chunks):
    """Chunked recompute: ``(dx f32 [N, H], dw f32 [H, V])``."""
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    dw = torch.empty(w.shape, dtype=torch.float32, device=x.device)
    for c0, c1 in _chunks(w.shape[1], num_chunks):
        w_c = w[:, c0:c1]
        z = _mm(x, w_c, x.dtype)
        p = torch.exp(z - lse[:, None])
        loc, mine = _owned(labels, c0, c1)
        cols = torch.arange(c1 - c0, device=x.device)
        p = p - ((loc[:, None] == cols[None, :]) & mine[:, None]).float()
        d = p * g[:, None]
        dw[:, c0:c1] = _mm(x.t(), d, x.dtype)
        dx += _mm(d, w_c.t(), x.dtype)
    return dx, dw


def _plain(x, w, labels):
    """The loss as one plain composition (all ``[N, V]`` logits at
    once, f32): what a second order differentiates."""
    z = torch.mm(x.float(), w.float())
    V = w.shape[1]
    mine = (labels >= 0) & (labels < V)
    picked = z.gather(1, labels.clamp(0, V - 1)[:, None])[:, 0]
    return torch.logsumexp(z, dim=-1) - torch.where(
        mine, picked, torch.zeros_like(picked))


class _FusedCE(torch.autograd.Function):
    """The chunked forward and backward.  Under grad mode (a
    ``create_graph`` pass) the backward goes through ``_plain`` instead,
    the logsumexp rebuilt from ``x`` and ``w`` under autograd, so every
    order is exact."""

    @staticmethod
    def forward(ctx, x, w, labels, num_chunks):
        lse, zl = _forward(x, w, labels, num_chunks)
        ctx.save_for_backward(x, w, labels, lse)
        ctx.num_chunks = num_chunks
        return lse - zl

    @staticmethod
    def backward(ctx, g):
        x, w, labels, lse = ctx.saved_tensors
        if torch.is_grad_enabled():
            return composed_backward(
                lambda a, b: _plain(a, b, labels), (x, w),
                ctx.needs_input_grad[:2], (g,)) + (None, None)
        dx, dw = _backward(x, w, labels, lse, g.float(), ctx.num_chunks)
        return dx.to(x.dtype), dw.to(w.dtype), None, None


def fused_linear_cross_entropy(x, w, labels, num_chunks=8):
    """Per-example CE of ``softmax(x @ w)`` against integer labels,
    without materialising the ``[N, V]`` logits.

    x: ``[N, H]`` (f32 or bf16), w: ``[H, V]``, labels: ``[N]`` int.
    Returns f32 ``[N]`` losses (the caller reduces); a label outside
    ``[0, V)`` picks no logit.  Differentiable in x and w."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f'fused_linear_cross_entropy: x [N, H] and w '
                         f'[H, V], got {tuple(x.shape)} and '
                         f'{tuple(w.shape)}')
    if int(num_chunks) < 1:
        raise ValueError(f'num_chunks must be >= 1, got {num_chunks}')
    labels = labels.reshape(-1).long()
    return _FusedCE.apply(x, w, labels, int(num_chunks))
