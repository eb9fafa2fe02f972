"""Fused matmul + bias + GELU: hand-written CUDA forward and recompute
backward, and the fc+GELU half of a transformer MLP.

Counterpart of ``paddle_tpu/ops/fused_gelu_linear.py``.  Its two TPU
kernels (``_fwd_kernel``, ``_bwd_kernel``) become
``csrc/fused_gelu_linear.cu`` (CUDA C++ for sm_90a; its header states
the bound and the design):

    forward : y  = gelu(x @ w + b)          one kernel, no z in memory
    backward: dz = dy * gelu'(x @ w + b)    one kernel, recomputes z
              dx = dz @ w.T ; dw = x.T @ dz ; db = sum(dz)   (torch)

Both kernels compute ``x @ w`` themselves, with an f32 accumulator; the
autograd function saves ``(x, w, b)`` and not the ``[M, N]``
pre-activation, the reference's design point.  ``dx``, ``dw`` and
``db`` (f32 sum) are plain ``torch.matmul``/``sum`` outside the
kernels, as the reference leaves them to XLA.  The kernels take f32,
bf16 or f16 ``x``/``w`` (one dtype; ``fused_linear_gelu`` promotes a
mixed pair), any ``M``, ``N``, ``K`` and an optional bias; the reference's
block-divisibility gate (``_pick_blocks``) and its bias requirement are
TPU rules and do not carry over.

Each entry point holds two designs, and the wrapper picks one per
launch by dtype and shape (``tensor_core_route``), before the launch:
bf16 or f16 with ``K % 8 == 0`` and ``N % 8 == 0`` takes the
tensor-core kernel (``wgmma`` fed by TMA, which needs every row on 16
bytes; a view whose data starts off 16 bytes is copied first); f32
(TF32 would change its numbers) and 16-bit inputs with other
``K``/``N`` take the SIMT kernel, which launches an ``M`` above 65535 *
128 rows in chunks.  It is a choice, not a fallback: a failed launch
raises.  Each kernel counts its launches by design in
``variant_launches`` (``'tensor_core'``, ``'simt'``).

Plain twins: ``_reference`` (the kernels' arithmetic: the product of
the operands widened to f32, not rounded to x's dtype before the bias
as the reference's jnp ``_reference`` does for 16-bit inputs) and
``_dz_reference`` (the backward kernel's ``dz``).  The forward is the
operator ``paddle_tpu_torch::linear_gelu`` (``ops/_library.py``), so
``torch.export`` keeps each launch as one node.  A wrapper runs a twin
only for a tensor on the CPU; on a CUDA tensor it launches its kernel or raises.

``mlp_gelu`` is the models' dispatch: ``fc`` then the tanh-form GELU by
default, or, with ``USE_PALLAS_MLP = True`` (the reference's opt-in
switch and name), ``fused_linear_gelu`` under the AMP name
``'fused_linear_gelu'``.
"""
import ctypes
import math

import torch

from ..amp import amp_cast
from ..nn import functional as F
from ..core.autograd import kernel_backward
from . import _library
from ._build import Kernel, aligned16, stream

__all__ = ['fused_linear_gelu', 'mlp_gelu', 'tensor_core_route',
           'USE_PALLAS_MLP']

# the reference's default: the models' MLPs take fc + GELU unless this
# is switched on (or fused_linear_gelu is called directly)
USE_PALLAS_MLP = False

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# the kernels' two designs, by the route tensor_core_route picks
VARIANTS = ('tensor_core', 'simt')

_ptr = ctypes.c_void_p
_int = ctypes.c_int
FWD_KERNEL = Kernel(
    'fused_linear_gelu_fwd', source='fused_gelu_linear',
    symbol='ptt_linear_gelu_fwd',
    argtypes=[_ptr] * 4 + [_int] * 6 + [_ptr],
    replaces='paddle_tpu/ops/fused_gelu_linear.py:72', variants=VARIANTS)
BWD_KERNEL = Kernel(
    'fused_linear_gelu_bwd', source='fused_gelu_linear',
    symbol='ptt_linear_gelu_bwd',
    argtypes=[_ptr] * 5 + [_int] * 6 + [_ptr],
    replaces='paddle_tpu/ops/fused_gelu_linear.py:84', variants=VARIANTS)


def _gelu_f32(z, approximate):
    if approximate:
        inner = _SQRT_2_OVER_PI * (z + 0.044715 * z * z * z)
        return 0.5 * z * (1.0 + torch.tanh(inner))
    return 0.5 * z * (1.0 + torch.erf(z / math.sqrt(2.0)))


def _gelu_grad_f32(z, approximate):
    if approximate:
        inner = _SQRT_2_OVER_PI * (z + 0.044715 * z * z * z)
        t = torch.tanh(inner)
        sech2 = 1.0 - t * t
        dinner = _SQRT_2_OVER_PI * (1.0 + 3 * 0.044715 * z * z)
        return 0.5 * (1.0 + t) + 0.5 * z * sech2 * dinner
    cdf = 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))
    pdf = torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    return cdf + z * pdf


def _preact(x2d, w, b):
    z = torch.matmul(x2d.float(), w.float())
    return z if b is None else z + b.float()


def _reference(x2d, w, b, approximate):
    """Plain twin of the forward kernel: ``gelu(x @ w + b)`` in f32, in
    x's dtype."""
    return _gelu_f32(_preact(x2d, w, b), approximate).to(x2d.dtype)


def _dz_reference(x2d, w, b, dy, approximate):
    """Plain twin of the backward kernel: ``dy * gelu'(x @ w + b)`` in
    f32, in x's dtype."""
    z = _preact(x2d, w, b)
    return (dy.float() * _gelu_grad_f32(z, approximate)).to(x2d.dtype)


def _checked(x2d, w, b, dy=None):
    """``(M, N, K, dtype code, f32 bias or None)`` after the kernels'
    checks."""
    code = _DTYPE_CODE.get(x2d.dtype)
    if code is None or w.dtype != x2d.dtype or (
            dy is not None and dy.dtype != x2d.dtype):
        raise TypeError(f'fused_linear_gelu kernels take one dtype, float32, '
                        f'bfloat16 or float16, for x, w (and dy); got '
                        f'{x2d.dtype}, {w.dtype}'
                        + ('' if dy is None else f', {dy.dtype}'))
    M, K = x2d.shape
    if w.dim() != 2 or w.shape[0] != K:
        raise ValueError(f'fused_linear_gelu: x [M, K] and w [K, N], got '
                         f'{tuple(x2d.shape)} and {tuple(w.shape)}')
    N = w.shape[1]
    if b is not None:
        if b.numel() != N:
            raise ValueError(f'fused_linear_gelu: bias must have N = {N} '
                             f'elements, got {b.numel()}')
        b = b.reshape(N).float().contiguous()
    if dy is not None and tuple(dy.shape) != (M, N):
        raise ValueError(f'fused_linear_gelu: dy {tuple(dy.shape)} is not '
                         f'[{M}, {N}]')
    for t in (x2d, w, b, dy):
        if t is None:
            continue
        if t.device != x2d.device:
            raise ValueError('fused_linear_gelu: every input must lie on '
                             f'{x2d.device}')
        if not t.is_contiguous():
            raise ValueError('fused_linear_gelu kernels need contiguous '
                             'inputs')
    if K < 1 or max(M, N, K) >= 2 ** 31:
        raise ValueError(f'fused_linear_gelu kernels take K >= 1 and dims '
                         f'below 2^31; got M={M}, N={N}, K={K}')
    return M, N, K, code, b


def tensor_core_route(x2d, w):
    """Whether the kernels take their tensor-core design for ``x2d [M,
    K]`` and ``w [K, N]``: bf16 or f16 with ``K`` and ``N`` multiples of
    8, so that every row of x, w and the output starts on 16 bytes, as
    TMA requires.  f32 (TF32 would change its numbers) and 16-bit inputs
    with other ``K`` or ``N`` take the SIMT design."""
    return (x2d.dtype in (torch.bfloat16, torch.float16)
            and x2d.shape[-1] % 8 == 0 and w.shape[-1] % 8 == 0)


def _launch(kernel, x2d, w, b, dy, approximate):
    """Check, pick the design, and launch ``kernel`` into a new output
    of x's dtype."""
    M, N, K, code, bf = _checked(x2d, w, b, dy)
    tc = tensor_core_route(x2d, w)
    if tc:  # TMA reads and writes from 16-byte-aligned bases
        x2d, w = aligned16(x2d, w)
        dy = None if dy is None else aligned16(dy)[0]
    out = torch.empty((M, N), dtype=x2d.dtype, device=x2d.device)
    ptrs = [x2d.data_ptr(), w.data_ptr(), None if bf is None else
            bf.data_ptr()] + ([] if dy is None else [dy.data_ptr()])
    kernel.launch(*ptrs, out.data_ptr(), M, N, K, int(bool(approximate)),
                  code, int(tc), stream(x2d.device),
                  variant=VARIANTS[0 if tc else 1])
    return out


def _fwd_cuda(x2d, w, b, approximate):
    """Launch the forward kernel: ``gelu(x @ w + b)`` in x's dtype."""
    return _launch(FWD_KERNEL, x2d, w, b, None, approximate)


def _bwd_cuda(x2d, w, b, dy, approximate):
    """Launch the backward kernel: ``dy * gelu'(x @ w + b)`` in x's
    dtype."""
    return _launch(BWD_KERNEL, x2d, w, b, dy, approximate)


def _on_cpu(t, name):
    if t.device.type != 'cpu':
        raise ValueError(f'{name}: no kernel for device {t.device}')


_OP = _library.op('linear_gelu').default


def _fwd(x2d, w, b, approximate):
    """The operator ``paddle_tpu_torch::linear_gelu``: the kernel for a
    CUDA tensor, the plain twin for a CPU one."""
    if not x2d.is_cuda:
        _on_cpu(x2d, 'fused_linear_gelu')
    return _OP(x2d, w, b, bool(approximate))


_BWD_OP = _library.op('linear_gelu_bwd').default


def _dz(x2d, w, b, dy, approximate):
    """The backward kernel for a CUDA tensor, the plain twin for a CPU
    one, and for a fake tensor the operator ``paddle_tpu_torch::
    linear_gelu_bwd`` (``_library.traced``)."""
    if _library.traced(x2d):
        return _BWD_OP(x2d, w, b, dy, bool(approximate))
    if x2d.is_cuda:
        return _bwd_cuda(x2d, w, b, dy, approximate)
    _on_cpu(x2d, 'fused_linear_gelu backward')
    return _dz_reference(x2d, w, b, dy, approximate)


class _FusedLinearGelu(torch.autograd.Function):
    """The forward kernel, and the ``dz`` kernel in the backward, on
    every pass.  Under grad mode (a ``create_graph`` pass) ``dz`` is a
    ``core.autograd.kernel_backward`` node whose own derivative is that
    of the plain composition ``_dz_reference``, and ``dx``/``dw``/``db``
    are torch products of it, so every order is exact: no kernel has a
    derivative of its own."""

    @staticmethod
    def forward(ctx, x2d, w, b, approximate):
        ctx.save_for_backward(x2d, w, b)
        ctx.approximate = approximate
        return _fwd(x2d, w, b, approximate)

    @staticmethod
    def backward(ctx, dy):
        x2d, w, b = ctx.saved_tensors
        approximate = ctx.approximate
        dz = kernel_backward(
            lambda x_, w_, b_, dy_: _dz(x_, w_, b_, dy_, approximate),
            lambda x_, w_, b_, dy_: _dz_reference(x_, w_, b_, dy_,
                                                  approximate),
            x2d, w, b, dy.contiguous())
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        dx = torch.matmul(dz, w.t()).to(x2d.dtype) if need_x else None
        dw = torch.matmul(x2d.t(), dz).to(w.dtype) if need_w else None
        db = dz.float().sum(dim=0).to(b.dtype) if need_b else None
        return dx, dw, db, None


def fused_linear_gelu(x, w, b, approximate=True):
    """``gelu(x @ w + b)`` for ``x [..., K]``, ``w [K, N]`` and ``b
    [N]`` (or None).  On CUDA tensors it launches the hand-written
    kernels (the forward here, the recompute ``dz`` in the backward) or
    raises; on CPU tensors it runs their plain twins.  The output has
    x's dtype, after x and w are promoted to one dtype."""
    dtype = torch.promote_types(x.dtype, w.dtype)
    lead, K = tuple(x.shape[:-1]), x.shape[-1]
    x2d = x.to(dtype).reshape(-1, K).contiguous()
    w = w.to(dtype).contiguous()
    approximate = bool(approximate)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x2d, w, b)):
        y = _FusedLinearGelu.apply(x2d, w, b, approximate)
    else:
        y = _fwd(x2d, w, b, approximate)
    return y.reshape(lead + (w.shape[1],))


def mlp_gelu(x, fc, shard_spec=None):
    """The fc+GELU half of a transformer MLP (``fc`` is a Linear with
    ``weight [in, out]`` and ``bias``): ``gelu(fc(x), approximate=True)``
    by default; with ``USE_PALLAS_MLP`` on, the fused kernels under the
    AMP name ``'fused_linear_gelu'`` (white-listed).  ``shard_spec`` is
    accepted for signature parity and has no effect on one device."""
    del shard_spec
    if USE_PALLAS_MLP:
        xv, wv, bv = amp_cast('fused_linear_gelu', x, fc.weight, fc.bias)
        return fused_linear_gelu(xv, wv, bv, approximate=True)
    return F.gelu(fc(x), approximate=True)
