"""Flash attention: hand-written CUDA forward and backward kernels.

Counterpart of ``paddle_tpu/ops/flash_attention.py``.  Its three TPU
kernels (``_fwd_kernel``, ``_bwd_dq_kernel``, ``_bwd_dkv_kernel``)
become ``csrc/flash_attention.cu`` (CUDA C++ for sm_90a; its header
states the bound and the design).  Layout ``[B*H, T, D]``, any ``B*H``
(the kernels launch in chunks of 65535 heads), f32 accumulation for
f32, bf16 and f16 inputs, outputs in the inputs' dtype, ``lse`` flat
``[B*H, T]`` f32.  Each kernel has two designs, picked by dtype before
the launch and counted per design in ``variant_launches``: bf16 and f16
inputs run all three on the tensor cores (``'mma'``: ``mma.sync``
tiles, P and dS rounded to the input type for the second product, as
the TPU's matrix unit rounds the operands of an f32 ``dot_general`` at
default precision); f32 inputs run SIMT f32 FMAs (``'simt'``).

Plain twins, in this module: ``_reference_lse`` (the reference's
forward twin, in torch) and ``_bwd_dq_reference``/``_bwd_dkv_reference``
(the backward kernels' algebra written out, clamp and masking
included).  The forward is the operator ``paddle_tpu_torch::
flash_attention_fwd`` (``ops/_library.py``), so ``torch.export`` keeps
each launch as one node; the backward kernels stay ``ctypes`` launches
(no inference path reaches them).  A wrapper runs a twin only for a
tensor on the CPU; on a
CUDA tensor it launches its kernel or raises.  ``chip_smoke.py`` holds
each kernel to its own twin on the card.

The backward is a ``torch.autograd.Function`` (the reference's
``custom_vjp``): ``delta = rowsum(do * o)`` is computed here, outside
the kernels, and the lse cotangent folds in as ``delta - g_lse``, which
keeps the lse gradient exact (d lse / d s = p).

The TPU gates (the ``_tuned_blocks`` table, ``DEFAULT_BLOCK_Q/K`` and
``shapes_tile``'s ``T % block``, blocks >= 128, ``d % 64``) do not
carry over: the kernels take any ``T >= 1`` (the ragged last tile is
masked inside) and ``D`` a multiple of 16 up to 128, with fixed tiles.
``block_q``/``block_k`` are validated and otherwise ignored.
"""
import ctypes
import math

import torch

from ..core.autograd import kernel_backward
from . import _library
from ._build import Kernel, aligned16, stream

__all__ = ['flash_attention', 'flash_attention_lse', 'can_use_pallas']

NEG_INF = -1e30
MAX_HEAD_DIM = 128

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# the kernels' two designs: tensor cores for 16-bit inputs, SIMT for f32
VARIANTS = ('mma', 'simt')

_ptr = ctypes.c_void_p
_int = ctypes.c_int
_TAIL = [_int, _int, _int, _int, ctypes.c_float, _int, _int, _ptr]
FWD_KERNEL = Kernel(
    'flash_attention_fwd', source='flash_attention',
    symbol='ptt_flash_attention_fwd', argtypes=[_ptr] * 5 + _TAIL,
    replaces='paddle_tpu/ops/flash_attention.py:151', variants=VARIANTS)
DQ_KERNEL = Kernel(
    'flash_attention_bwd_dq', source='flash_attention',
    symbol='ptt_flash_attention_bwd_dq', argtypes=[_ptr] * 7 + _TAIL,
    replaces='paddle_tpu/ops/flash_attention.py:245', variants=VARIANTS)
DKV_KERNEL = Kernel(
    'flash_attention_bwd_dkv', source='flash_attention',
    symbol='ptt_flash_attention_bwd_dkv', argtypes=[_ptr] * 8 + _TAIL,
    replaces='paddle_tpu/ops/flash_attention.py:295', variants=VARIANTS)


def _causal_code(causal):
    return 2 if causal == 'strict' else (1 if causal else 0)


def _keep_mask(tq, tk, causal, device):
    """``[tq, tk]`` bool, True where a (row, col) cell is attended; None
    without a causal mode."""
    if not causal:
        return None
    return torch.ones((tq, tk), dtype=torch.bool, device=device).tril(
        -1 if causal == 'strict' else 0)


def _scores(q, k, causal, scale):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    keep = _keep_mask(q.shape[1], k.shape[1], causal, q.device)
    if keep is not None:
        s = torch.where(keep, s, torch.full((), NEG_INF, device=s.device))
    return s, keep


def _reference_lse(q, k, v, causal, scale):
    """Plain twin of the forward kernel (the reference's
    ``_reference_lse``): ``(o f32, lse f32 [bh, tq])``.  A fully masked
    row (strict mode's row 0) gets ``o = 0`` and ``lse = -1e29 +
    log(1e-30)`` instead of a uniform row."""
    s, _ = _scores(q, k, causal, scale)
    m = torch.clamp_min(s.amax(dim=-1, keepdim=True), -1e29)
    p = torch.where(s <= NEG_INF / 2, torch.zeros((), device=s.device),
                    torch.exp(s - m))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, v.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return o, lse


def _reference(q, k, v, causal, scale):
    return _reference_lse(q, k, v, causal, scale)[0].to(q.dtype)


def _bwd_probs(q, k, v, do, lse, delta, causal, scale):
    """The backward kernels' shared algebra: ``p = exp(min(s - lse,
    0))`` (0 on masked cells) and ``ds = p * (do.v^T - delta) *
    scale``, f32 ``[bh, tq, tk]``."""
    s, keep = _scores(q, k, causal, scale)
    p = torch.exp(torch.clamp_max(s - lse[..., None], 0.0))
    if keep is not None:
        p = torch.where(keep, p, torch.zeros((), device=p.device))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    return p, ds


def _bwd_dq_reference(q, k, v, do, lse, delta, causal, scale):
    """Plain twin of the dq kernel: ``dq = ds.k`` in q's dtype."""
    _, ds = _bwd_probs(q, k, v, do, lse, delta, causal, scale)
    return torch.matmul(ds, k.float()).to(q.dtype)


def _bwd_dkv_reference(q, k, v, do, lse, delta, causal, scale):
    """Plain twin of the dk/dv kernel: ``dk = ds^T.q``, ``dv =
    p^T.do`` in k's and v's dtypes."""
    p, ds = _bwd_probs(q, k, v, do, lse, delta, causal, scale)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()).to(k.dtype)
    dv = torch.matmul(p.transpose(-1, -2), do.float()).to(v.dtype)
    return dk, dv


def can_use_pallas(tq, tk, d, block_q=None, block_k=None):
    """True iff the CUDA kernels take these shapes: any ``tq, tk >=
    1`` and ``d`` a multiple of 16 up to 128 (and any ``B*H``).  (The
    name is the reference's; ``block_q``/``block_k`` are validated, the
    kernels use fixed 64-row tiles.)"""
    _check_blocks(block_q, block_k)
    return (int(tq) >= 1 and int(tk) >= 1 and int(d) % 16 == 0
            and 16 <= int(d) <= MAX_HEAD_DIM)


def _check_blocks(block_q, block_k):
    for name, b in (('block_q', block_q), ('block_k', block_k)):
        if b is not None and (isinstance(b, bool) or int(b) != b
                              or int(b) < 1):
            raise ValueError(f'{name} must be a positive int, got {b!r}')


def _check(name, tensors, dtype=None):
    """Device, dtype, rank and contiguity checks before a launch."""
    device = tensors[0].device
    dtype = dtype or tensors[0].dtype
    if dtype not in _DTYPE_CODE:
        raise TypeError(f'{name} kernel takes float32, bfloat16 or '
                        f'float16, got {dtype}')
    for t in tensors:
        if t.device != device:
            raise ValueError(f'{name}: every input must lie on {device}')
        if t.dim() != 3 or t.dtype != dtype:
            raise ValueError(f'{name}: expected [B*H, T, D] {dtype} '
                             f'tensors, got {tuple(t.shape)} {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name} kernel needs contiguous inputs')
    return device, _DTYPE_CODE[dtype]


def _dims(q, k, v):
    bh, tq, d = q.shape
    if k.shape != (bh, k.shape[1], d) or v.shape != k.shape:
        raise ValueError(f'flash_attention: q {tuple(q.shape)}, k '
                         f'{tuple(k.shape)}, v {tuple(v.shape)} do not '
                         'match')
    tk = k.shape[1]
    if not can_use_pallas(tq, tk, d):
        raise ValueError(f'flash_attention kernels need T >= 1 and D % 16 '
                         f'== 0, D <= {MAX_HEAD_DIM}; got tq={tq}, '
                         f'tk={tk}, D={d}')
    return bh, tq, tk, d


def _variant(code):
    """The design a launch takes: tensor cores for 16-bit inputs."""
    return VARIANTS[code == _DTYPE_CODE[torch.float32]]


def _aligned(code, *tensors):
    """The tensor-core kernels (bf16, f16) copy 16 bytes at a time."""
    if code == _DTYPE_CODE[torch.float32]:
        return tensors
    return aligned16(*tensors)


def _fwd_cuda(q, k, v, causal, scale):
    """Launch the forward kernel: ``(o, lse)``."""
    device, code = _check('flash_attention_fwd', (q, k, v))
    bh, tq, tk, d = _dims(q, k, v)
    q, k, v = _aligned(code, q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=device)
    FWD_KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      o.data_ptr(), lse.data_ptr(), bh, tq, tk, d,
                      float(scale), _causal_code(causal), code,
                      stream(device), variant=_variant(code))
    return o, lse


def _bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale):
    device, code = _check('flash_attention_bwd_dq', (q, k, v, do))
    _check('flash_attention_bwd_dq', (lse[..., None], delta[..., None]),
           torch.float32)
    bh, tq, tk, d = _dims(q, k, v)
    q, k, v, do = _aligned(code, q, k, v, do)
    dq = torch.empty_like(q)
    DQ_KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                     dq.data_ptr(), bh, tq, tk, d, float(scale),
                     _causal_code(causal), code, stream(device),
                     variant=_variant(code))
    return dq


def _bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale):
    device, code = _check('flash_attention_bwd_dkv', (q, k, v, do))
    _check('flash_attention_bwd_dkv', (lse[..., None], delta[..., None]),
           torch.float32)
    bh, tq, tk, d = _dims(q, k, v)
    q, k, v, do = _aligned(code, q, k, v, do)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    DKV_KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(), bh, tq, tk, d,
                      float(scale), _causal_code(causal), code,
                      stream(device), variant=_variant(code))
    return dk, dv


def _on_cpu(t, name):
    if t.device.type != 'cpu':
        raise ValueError(f'{name}: no kernel for device {t.device}')


def _fwd_twin(q, k, v, causal, scale):
    """The forward kernel's plain twin: ``(o in q's dtype, lse
    f32)``."""
    o, lse = _reference_lse(q, k, v, causal, scale)
    return o.to(q.dtype), lse


_OP = _library.op('flash_attention_fwd').default


def _fwd(q, k, v, causal, scale):
    """``(o in q's dtype, lse f32)`` from the operator
    ``paddle_tpu_torch::flash_attention_fwd``: the kernel for a CUDA
    tensor, the plain twin for a CPU one."""
    if not q.is_cuda:
        _on_cpu(q, 'flash_attention')
    return _OP(q, k, v, _causal_code(causal), float(scale))


_DQ_OP = _library.op('flash_attention_bwd_dq').default
_DKV_OP = _library.op('flash_attention_bwd_dkv').default


def _bwd(q, k, v, o, lse, do, g_lse, causal, scale):
    """``(dq, dk, dv)``: the kernels for CUDA tensors, the plain twins
    for CPU ones, and for fake tensors the operators ``paddle_tpu_torch::
    flash_attention_bwd_dq``/``_dkv`` (``_library.traced``); ``delta``
    here, outside the kernels."""
    delta = (do.float() * o.float()).sum(dim=-1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    if _library.traced(q):
        args = (q, k, v, do, lse, delta, _causal_code(causal), float(scale))
        return (_DQ_OP(*args), *_DKV_OP(*args))
    args = (q, k, v, do, lse, delta, causal, scale)
    if q.is_cuda:
        return (_bwd_dq_cuda(*args), *_bwd_dkv_cuda(*args))
    _on_cpu(q, 'flash_attention backward')
    return (_bwd_dq_reference(*args), *_bwd_dkv_reference(*args))


def _bwd_twin(q, k, v, do, g_lse, causal, scale):
    """The backward kernels' function in plain PyTorch: ``(dq, dk,
    dv)``, the gradient of ``_fwd_twin`` with its graph, so that it
    differentiates onwards in every input."""
    qkv = [t if t.requires_grad else t.detach().requires_grad_()
           for t in (q, k, v)]
    with torch.enable_grad():
        o, lse = _fwd_twin(*qkv, causal, scale)
        outs, seeds = [o], [do.to(o.dtype)]
        if g_lse is not None:
            outs.append(lse)
            seeds.append(g_lse.float())
        return torch.autograd.grad(outs, qkv, seeds, create_graph=True)


class _Flash(torch.autograd.Function):
    """The forward kernel, and the dq and dk/dv kernels in the
    backward, on every pass.  Under grad mode (a ``create_graph`` pass)
    the kernels' gradients are a ``core.autograd.kernel_backward`` node
    whose own derivative is that of the plain composition
    (``_bwd_twin``), so every order is exact: no kernel has a derivative
    of its own."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = _fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, g_o, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale = ctx.causal, ctx.scale
        # the twin recomputes o and lse: the saved ones are constants here
        o, lse = o.detach(), lse.detach()
        do = torch.zeros_like(o) if g_o is None else g_o.contiguous()
        dq, dk, dv = kernel_backward(
            lambda q_, k_, v_, do_, g_: _bwd(q_, k_, v_, o, lse, do_, g_,
                                             causal, scale),
            lambda q_, k_, v_, do_, g_: _bwd_twin(q_, k_, v_, do_, g_,
                                                  causal, scale),
            q, k, v, do, g_lse)
        return dq, dk, dv, None, None


def _run(q, k, v, causal, scale):
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, causal, scale)
    return _fwd(q, k, v, causal, scale)


def flash_attention_lse(q, k, v, causal, scale, block_q=None,
                        block_k=None):
    """Attention returning ``(o, lse [bh, tq] f32)`` for streaming-merge
    callers; both outputs are differentiable (the lse cotangent folds
    into the backward kernels as ``delta - g_lse``)."""
    _check_blocks(block_q, block_k)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _run(q, k, v, causal, float(scale))


def flash_attention(q, k, v, causal=False, scale=None, block_q=None,
                    block_k=None):
    """Tiled attention over ``[B*H, T, D]`` tensors: causal ``False``,
    ``True`` or ``'strict'`` (a token does not see itself; a row with
    no valid column is zero).  On CUDA tensors it launches the
    hand-written kernels (forward here, dq and dk/dv in the backward)
    or raises; on CPU tensors it runs their plain twins."""
    return flash_attention_lse(q, k, v, causal, scale, block_q,
                               block_k)[0]
