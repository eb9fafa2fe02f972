"""Fused LayerNorm: hand-written CUDA forward, plain backward.

Counterpart of ``paddle_tpu/ops/fused_norm.py``.  The TPU kernel
``_fwd_kernel`` there becomes ``csrc/fused_norm.cu`` (CUDA C++ for
sm_90a; its header states the bound and the designs) for f32, bf16 and
f16 x and any H.  The wrapper names the design of each launch, before
it, in ``variant_launches``: ``'warp'`` up to H 2048 (one row a
32-thread block, gamma/beta loaded with x up to H 1024), ``'block'``
above (one block a row, the row read once into registers).  Both take
vector loads where H % 4 == 0 and the data starts on 16 bytes, scalar
loads otherwise.
The forward is the operator ``paddle_tpu_torch::fused_layer_norm``
(``ops/_library.py``), so ``torch.export`` keeps it as one node.
``_reference`` is the plain PyTorch twin: the operator runs it only for
a tensor on the CPU, and ``chip_smoke.py`` holds the kernel to it on
the card.  The backward ``_ln_bwd`` is plain PyTorch, as the
reference's is jnp: the JAX package has no backward kernel.  A second
order (``grad(create_graph=True)``) goes through the plain composition
(``core.autograd.composed_backward``).
"""
import ctypes

import torch

from ..core.autograd import composed_backward
from . import _library
from ._build import Kernel, stream

__all__ = ['fused_layer_norm']

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_WARP_MAX_H = 2048                   # the widest row of the 'warp' design
VARIANTS = ('warp', 'block')         # the C entry point's design codes

_ptr = ctypes.c_void_p
KERNEL = Kernel(
    'fused_layer_norm', source='fused_norm', symbol='ptt_layer_norm_fwd',
    argtypes=[_ptr, _ptr, _ptr, _ptr, _ptr, _ptr, ctypes.c_int,
              ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, _ptr],
    replaces='paddle_tpu/ops/fused_norm.py:34', variants=VARIANTS)


def _reference(x2d, gamma, beta, eps):
    """Plain twin of the kernel: ``(y, mean, rstd)`` for ``x2d [N, H]``,
    f32 statistics with the two-pass variance, ``y`` in x's dtype."""
    xf = x2d.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd
    if gamma is not None:
        y = y * gamma.float()
    if beta is not None:
        y = y + beta.float()
    return y.to(x2d.dtype), mean[:, 0], rstd[:, 0]


def _affine(t, device, h):
    """gamma or beta (or None) in f32, after the kernel's checks.  Any
    alignment: the kernel takes its vector loads only where every
    pointer starts on 16 bytes and H % 4 == 0, scalar loads otherwise."""
    if t is None:
        return None
    if t.dtype != torch.float32:
        t = t.float()
    if t.device != device:
        raise ValueError('fused_layer_norm: x, gamma and beta must lie '
                         'on one device')
    if t.numel() != h:
        raise ValueError('fused_layer_norm: gamma/beta must have H '
                         'elements')
    if not t.is_contiguous():
        raise ValueError('fused_layer_norm kernel needs contiguous inputs')
    return t


def _fwd_cuda(x2d, gamma, beta, eps):
    """Launch the kernel; raises on what it does not take.  Host work
    per call is kept small: at the serving decode shape the kernel
    runs for about 2 us, so the wrapper's own time is the larger part
    of a call."""
    n, h = x2d.shape
    code = _DTYPE_CODE.get(x2d.dtype)
    if code is None:
        raise TypeError(f'fused_layer_norm kernel takes float32, bfloat16 '
                        f'or float16, got {x2d.dtype}')
    if not x2d.is_contiguous():
        raise ValueError('fused_layer_norm kernel needs contiguous inputs')
    device = x2d.device
    # kept alive through the launch: a cast copy's memory must not go to y
    gamma = _affine(gamma, device, h)
    beta = _affine(beta, device, h)
    y = torch.empty_like(x2d)
    stats = torch.empty((2, n), dtype=torch.float32, device=device)
    ps = stats.data_ptr()
    block = h > _WARP_MAX_H
    KERNEL.launch(x2d.data_ptr(),
                  None if gamma is None else gamma.data_ptr(),
                  None if beta is None else beta.data_ptr(), y.data_ptr(),
                  ps, ps + 4 * n, n, h, float(eps), code, block,
                  stream(device), variant=VARIANTS[block])
    return y, stats[0], stats[1]


_OP = _library.op('fused_layer_norm').default


def _fwd(x2d, gamma, beta, eps):
    """The operator ``paddle_tpu_torch::fused_layer_norm``: the kernel
    for a CUDA tensor, the plain twin for a CPU one."""
    if x2d.device.type not in ('cuda', 'cpu'):
        raise ValueError(f'fused_layer_norm: no kernel for device '
                         f'{x2d.device}')
    return _OP(x2d, gamma, beta, float(eps))


def _ln_bwd(x2d, gamma, mean, rstd, g):
    """Plain backward from the saved statistics: ``(dx, dgamma,
    dbeta)``, the same algebra as the reference's ``_ln_bwd``."""
    xf = x2d.float()
    gf = g.float()
    xhat = (xf - mean[:, None]) * rstd[:, None]
    dy = gf if gamma is None else gf * gamma.float()
    dx = (dy - dy.mean(dim=-1, keepdim=True)
          - xhat * (dy * xhat).mean(dim=-1, keepdim=True)) * rstd[:, None]
    dgamma = (gf * xhat).sum(dim=0)
    dbeta = gf.sum(dim=0)
    return dx.to(x2d.dtype), dgamma, dbeta


class _LayerNorm(torch.autograd.Function):
    """The kernel's forward and ``_ln_bwd``.  Under grad mode (a
    ``create_graph`` pass) the backward goes through the plain
    composition ``_reference`` instead, its statistics rebuilt from
    ``x`` under autograd, so every order is exact; no hand-written
    kernel has a derivative of its own."""

    @staticmethod
    def forward(ctx, x2d, gamma, beta, eps):
        y, mean, rstd = _fwd(x2d, gamma, beta, eps)
        ctx.save_for_backward(x2d, gamma, beta, mean, rstd)
        ctx.eps = eps
        ctx.has_beta = beta is not None
        ctx.dtypes = (None if gamma is None else gamma.dtype,
                      None if beta is None else beta.dtype)
        return y

    @staticmethod
    def backward(ctx, g):
        x2d, gamma, beta, mean, rstd = ctx.saved_tensors
        if torch.is_grad_enabled():
            return composed_backward(
                lambda x, w, b: _reference(x, w, b, ctx.eps)[0],
                (x2d, gamma, beta), ctx.needs_input_grad[:3], (g,)) \
                + (None,)
        dx, dgamma, dbeta = _ln_bwd(x2d, gamma, mean, rstd, g)
        gdt, bdt = ctx.dtypes
        return (dx,
                None if gamma is None else dgamma.to(gdt),
                dbeta.to(bdt) if ctx.has_beta else None,
                None)


def fused_layer_norm(x, gamma=None, beta=None, eps=1e-5):
    """LayerNorm over the last axis of ``x``.  On a CUDA tensor it
    launches the hand-written kernel (or raises); on a CPU tensor it
    runs the plain twin.  Differentiable through ``_ln_bwd``."""
    x2d = x.reshape(-1, x.shape[-1]).contiguous()
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x2d, gamma, beta)):
        y = _LayerNorm.apply(x2d, gamma, beta, float(eps))
    else:
        # nothing to differentiate (serving runs under no_grad): skip
        # the autograd.Function's bookkeeping
        y = _fwd(x2d, gamma, beta, eps)[0]
    return y.reshape(x.shape)
