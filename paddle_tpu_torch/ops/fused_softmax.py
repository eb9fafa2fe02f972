"""Fused (optionally masked) softmax: hand-written CUDA forward, plain
backward.

Counterpart of ``paddle_tpu/ops/fused_softmax.py``.  Its two TPU kernels
(``_kernel`` and ``_masked_kernel``) become ``csrc/fused_softmax.cu``
(CUDA C++ for sm_90a; its header states the bound and the designs):
softmax over the last axis in f32, of ``x + mask`` in the masked
variant, the output in x's dtype (f32, bf16 or f16), any row length and
any number of rows.

Both kernels hold three designs, and ``design`` picks one per launch,
before it, from the row and the pointers: ``'vec'`` (rows up to 1024
columns whose bytes are a multiple of 16, x and y on 16 bytes: 16-byte
loads and stores, a power-of-two group of lanes a row), ``'scalar'``
(the other rows up to 512: one warp a row, one element a load) and
``'block'`` (the rest: one block a row, two passes).  Each launch
counts under its design in ``variant_launches``.

The mask is indexed by strides, not materialised: the reference
broadcasts it to x's shape in HBM before its kernel (``:97-99``); here
the wrapper takes ``mask.expand(x.shape)`` (stride 0 on every broadcast
dim), coalesces x's leading dims to at most four, and the kernel maps
each row to its mask offset.  A mask is cast to f32 before the
broadcast (the reference's kernel reads it as f32), which for a
broadcast padding mask is a few KB.

The forwards are the operators ``paddle_tpu_torch::fused_softmax`` and
``::fused_softmax_masked`` (``ops/_library.py``), so ``torch.export``
keeps each launch as one node.  ``_reference`` is the plain PyTorch
twin (the reference's ``_reference``): the operators run it only for a
tensor on the CPU, and
``chip_smoke.py`` holds the kernels to it on the card.  The backward is
the reference's ``_sm_bwd`` in plain PyTorch, as the reference's is jnp:
``dx = y * (g - sum(g * y))`` in f32, cast to y's dtype, and the mask's
gradient is ``dx`` summed to the mask's shape.

``block_rows`` is the reference's TPU row-block size: it is validated
and ignored (the kernels take a group of lanes, a warp or a block per
row), and neither its ``h % 128`` nor its row-block gate (``:95``)
carries over.
"""
import ctypes

import torch

from . import _library
from ._build import Kernel, stream

__all__ = ['fused_softmax']

_BLOCK_ROWS = 256
_MASK_DIMS = 4          # leading dims the kernel's mask index takes
_MAX_VEC_ROW = 1024     # the longest row of the 'vec' design
_MAX_SCALAR_ROW = 512   # of the 'scalar' design
VARIANTS = ('vec', 'scalar', 'block')     # the C entry points' design codes

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_ptr = ctypes.c_void_p
_int = ctypes.c_int
KERNEL = Kernel(
    'fused_softmax', source='fused_softmax', symbol='ptt_softmax_fwd',
    argtypes=[_ptr, _ptr, _int, _int, _int, _int, _ptr],
    replaces='paddle_tpu/ops/fused_softmax.py:26', variants=VARIANTS)
MASKED_KERNEL = Kernel(
    'fused_softmax_masked', source='fused_softmax',
    symbol='ptt_softmax_masked_fwd',
    argtypes=[_ptr, _ptr, _ptr, _int, _int,
              ctypes.POINTER(ctypes.c_longlong), _int, _int, _ptr],
    replaces='paddle_tpu/ops/fused_softmax.py:33', variants=VARIANTS)


def _reference(x, mask):
    """Plain twin of both kernels: softmax of ``x`` (``+ mask``) over
    the last axis in f32, in x's dtype."""
    xf = x.float()
    if mask is not None:
        xf = xf + mask.float()
    return torch.softmax(xf, dim=-1).to(x.dtype)


def _mask_meta(mask, shape):
    """``(mask f32 view, meta)`` for the masked kernel: ``meta`` holds
    ``d1, d2, d3, s0, s1, s2, s3, sh`` (``csrc/fused_softmax.cu``'s
    ``MaskIndex``).  x's leading dims are coalesced where the mask's
    strides allow; more than four that do not coalesce make the mask
    contiguous at x's shape first."""
    m = mask if mask.dtype == torch.float32 else mask.float()
    m = m.expand(shape)
    dims = []
    for size, stride in zip(shape[:-1], m.stride()[:-1]):
        if size == 1:
            continue
        if dims and dims[-1][1] == stride * size:
            dims[-1] = (dims[-1][0] * size, stride)
        else:
            dims.append((size, stride))
    if len(dims) > _MASK_DIMS:
        m = m.contiguous()
        n = m.numel() // shape[-1]
        dims = [(n, shape[-1])]
    dims = [(1, 0)] * (_MASK_DIMS - len(dims)) + dims
    sizes, strides = zip(*dims)
    meta = (ctypes.c_longlong * 8)(*sizes[1:], *strides, m.stride()[-1])
    return m, meta


def design(x, y):
    """The design a launch on ``x`` (``y`` its output) takes: ``'vec'``
    for rows up to 1024 columns whose bytes are a multiple of 16 with x
    and y on 16 bytes, ``'scalar'`` for other rows up to 512 columns,
    ``'block'`` for the rest."""
    h = x.shape[-1]
    if (h <= _MAX_VEC_ROW and h * x.element_size() % 16 == 0
            and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0):
        return 'vec'
    return 'scalar' if h <= _MAX_SCALAR_ROW else 'block'


def _fwd_cuda(x, mask):
    """Launch the kernel (the masked one when ``mask`` is given) on a
    contiguous ``x``; raises on what it does not take."""
    code = _DTYPE_CODE.get(x.dtype)
    if code is None:
        raise TypeError(f'fused_softmax kernel takes float32, bfloat16 or '
                        f'float16, got {x.dtype}')
    if not x.is_contiguous():
        raise ValueError('fused_softmax kernel needs a contiguous x')
    h = x.shape[-1]
    n = x.numel() // h if h else 0
    if n >= 2 ** 31 or h >= 2 ** 31:
        raise ValueError(f'fused_softmax kernel takes fewer than 2^31 rows '
                         f'and columns, got {n} x {h}')
    y = torch.empty_like(x)
    if n == 0:
        return y
    variant = design(x, y)
    if mask is None:
        KERNEL.launch(x.data_ptr(), y.data_ptr(), n, h, code,
                      VARIANTS.index(variant), stream(x.device),
                      variant=variant)
        return y
    if mask.device != x.device:
        raise ValueError(f'fused_softmax: mask on {mask.device}, x on '
                         f'{x.device}')
    m, meta = _mask_meta(mask, x.shape)
    MASKED_KERNEL.launch(x.data_ptr(), m.data_ptr(), y.data_ptr(), n, h,
                         meta, code, VARIANTS.index(variant),
                         stream(x.device), variant=variant)
    return y


_OP = _library.op('fused_softmax').default
_MASKED_OP = _library.op('fused_softmax_masked').default


def _fwd(x, mask):
    """The operators ``paddle_tpu_torch::fused_softmax`` and
    ``::fused_softmax_masked``: the kernels for a CUDA tensor, the plain
    twin for a CPU one."""
    if x.device.type not in ('cuda', 'cpu'):
        raise ValueError(f'fused_softmax: no kernel for device {x.device}')
    return _OP(x) if mask is None else _MASKED_OP(x, mask)


def _sm_bwd(y, g):
    """The reference's ``_sm_bwd``: ``dx = y * (g - sum(g * y))`` in
    f32, in y's dtype."""
    yf, gf = y.float(), g.float()
    return (yf * (gf - (gf * yf).sum(dim=-1, keepdim=True))).to(y.dtype)


class _Softmax(torch.autograd.Function):
    """The kernel's forward and ``_sm_bwd`` from the saved output.
    ``_sm_bwd`` is plain PyTorch in ``y`` and ``g``, and ``y`` carries
    this Function's own graph, so a second order through it is exact
    as it stands."""

    @staticmethod
    def forward(ctx, x, mask):
        y = _fwd(x, mask)
        ctx.save_for_backward(y)
        ctx.mask_meta = None if mask is None else (mask.shape, mask.dtype)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        dx = _sm_bwd(y, g)
        dmask = None
        if ctx.needs_input_grad[1]:
            # d/dmask of softmax(x + mask) is d/dx, summed over the dims
            # the mask was broadcast along
            shape, dtype = ctx.mask_meta
            dmask = dx.float().sum_to_size(shape).to(dtype)
        return dx, dmask


def _check_block_rows(block_rows):
    if (isinstance(block_rows, bool) or int(block_rows) != block_rows
            or int(block_rows) < 1):
        raise ValueError(f'block_rows must be a positive int, got '
                         f'{block_rows!r}')


def _broadcasts_to(shape, target):
    try:
        return tuple(torch.broadcast_shapes(shape, target)) == tuple(target)
    except RuntimeError:
        return False


def fused_softmax(x, mask=None, block_rows=_BLOCK_ROWS):
    """Softmax over the last axis of ``x``, of ``x + mask`` when an
    additive ``mask`` (broadcastable to x's shape) is given, computed
    in f32 and returned in x's dtype.  On a CUDA tensor it launches the
    hand-written kernel (or raises); on a CPU tensor it runs the plain
    twin.  Differentiable in ``x`` and ``mask``.  ``block_rows`` is
    validated and ignored (module docstring)."""
    _check_block_rows(block_rows)
    if x.dim() == 0:
        raise ValueError('fused_softmax needs at least one axis')
    if mask is not None and not _broadcasts_to(mask.shape, x.shape):
        raise ValueError(f'fused_softmax: mask {tuple(mask.shape)} does '
                         f'not broadcast to x {tuple(x.shape)}')
    x = x.contiguous()
    if torch.is_grad_enabled() and (
            x.requires_grad or (mask is not None and mask.requires_grad)):
        return _Softmax.apply(x, mask)
    return _fwd(x, mask)
