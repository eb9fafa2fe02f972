"""The port's hand-written CUDA kernels against their plain twins, on
the card.

Every test here is marked ``cuda`` and skips where no CUDA device
exists (this file imports neither JAX nor the JAX package, so it also
runs on a machine without them).  On the card, from the repository
root:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerances, LayerNorm: f32 1e-5 (the kernel sums a row in another
order than PyTorch's reductions); bf16 and f16 2e-2 on y (both round y
to the 16-bit type, from f32 values that differ in the last bits), 1e-5
on the f32 statistics.  The widths cover the warp design with vector
loads (768, 2048), with scalar loads (130, 770: H % 4 != 0) and the
block design above 2048 (2560, 4096).

Tolerances, flash attention (each kernel against its own plain twin on
the same inputs): f32 1e-5 on o and lse and 1e-4 on dq/dk/dv (the
kernel's online softmax and tile sums run in another order than the
twin's matmuls over whole rows); bf16 and f16 2e-2 on o/dq/dk/dv (both
round the f32 result to the 16-bit type, and the tensor-core kernels
also round P and dS to it before their second products; on the CPU,
``tests/test_torch_flash_attention.py`` replays that rounding and holds
it within half this bound at T 200) and 1e-4 on the f32 lse.  The
16-bit shapes straddle the tensor-core kernels' tiles (64 q rows and
64-key K/V tiles in the forward; 64 q rows and 64- or, above D = 64,
32-key K/V tiles in dq; 64 keys and 64- or 32-row Q/dO tiles in dk/dv)
and their D instantiations (32, 64, 128).

Tolerances, softmax (plain and masked): f32 1e-6 on y (one exp and one
division per element; the row's sums in another order); bf16 2^-8 and
f16 2^-10 (both round an f32 value below 1 to the 16-bit type, whose
step there is at most 2^-8 and 2^-11).

Tolerances, GEMM+GELU forward and backward: f32 1e-4 * (1 + |twin|)
(K-term products accumulated in another order than cuBLAS's); bf16 2e-2
* (1 + |twin|), f16 the same (both round the f32 result to the 16-bit
type).  The 16-bit shapes of the tensor-core design straddle its 128 x
256 output tiles (M 129 and 8191, N 136 and 3000) and its 64-deep K
slices (K 8, 64, 72, 776); an M of 65535 * 128 + 1000 makes the SIMT
design launch in two chunks.
"""
import importlib

import numpy as np
import pytest
import torch

fa = importlib.import_module('paddle_tpu_torch.ops.flash_attention')
from paddle_tpu_torch.ops import fused_gelu_linear as fgl
from paddle_tpu_torch.ops import fused_norm

# the module: the package's `fused_softmax` attribute is the function
fsm = importlib.import_module('paddle_tpu_torch.ops.fused_softmax')


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


def _inputs(n, h, dtype, seed=9):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy((rs.randn(n, h) * 2.0 + 0.5).astype(np.float32))
    g = torch.from_numpy((1.0 + 0.1 * rs.randn(h)).astype(np.float32))
    b = torch.from_numpy((0.1 * rs.randn(h)).astype(np.float32))
    return x.cuda().to(dtype), g.cuda(), b.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize('n,h', [(64, 768), (512, 768), (7, 2048),
                                 (3, 132), (9, 130), (33, 770), (5, 2560),
                                 (3, 4096), (2, 4099)])
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 2e-2)])
def test_layer_norm_kernel_matches_plain_twin(n, h, dtype, tol):
    _cuda()
    x, g, b = _inputs(n, h, dtype)
    before = fused_norm.KERNEL.launches
    y, mean, rstd = fused_norm._fwd_cuda(x, g, b, 1e-5)
    ry, rmean, rrstd = fused_norm._reference(x, g, b, 1e-5)
    torch.cuda.synchronize()
    assert fused_norm.KERNEL.launches == before + 1
    torch.testing.assert_close(y.float(), ry.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(mean, rmean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rstd, rrstd, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_layer_norm_kernel_without_affine_and_through_autograd():
    _cuda()
    x, g, b = _inputs(16, 256, torch.float32)
    y, _, _ = fused_norm._fwd_cuda(x, None, None, 1e-5)
    ry, _, _ = fused_norm._reference(x, None, None, 1e-5)
    torch.testing.assert_close(y, ry, rtol=1e-5, atol=1e-5)
    xs, gs, bs = (t.clone().requires_grad_() for t in (x, g, b))
    fused_norm.fused_layer_norm(xs, gs, bs).square().sum().backward()
    xc, gc, bc = (t.detach().cpu().requires_grad_() for t in (x, g, b))
    fused_norm.fused_layer_norm(xc, gc, bc).square().sum().backward()
    for a, c in ((xs, xc), (gs, gc), (bs, bc)):
        torch.testing.assert_close(a.grad.cpu(), c.grad, rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.cuda
def test_layer_norm_kernel_refuses_what_it_does_not_take():
    _cuda()
    x, g, b = _inputs(4, 130, torch.float32)
    with pytest.raises(ValueError, match='H elements'):
        fused_norm._fwd_cuda(x, g[:128], b[:128], 1e-5)
    with pytest.raises(ValueError, match='contiguous'):
        fused_norm._fwd_cuda(x.t().contiguous().t(), g, b, 1e-5)
    x, g, b = _inputs(4, 128, torch.float64)
    with pytest.raises(TypeError):
        fused_norm._fwd_cuda(x, g, b, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize('h', [768, 2560])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float16])
def test_layer_norm_kernel_takes_views_off_16_bytes(h, dtype):
    """A contiguous view whose data starts off 16 bytes takes the scalar
    loads; the result matches the twin."""
    _cuda()
    x, g, b = _inputs(6, h, dtype, seed=10)
    flat = torch.empty(x.numel() + 1, dtype=dtype, device='cuda')
    flat[1:].copy_(x.reshape(-1))
    view = flat[1:].view(x.shape)
    assert view.is_contiguous() and view.data_ptr() % 16
    y, mean, rstd = fused_norm._fwd_cuda(view, g, b, 1e-5)
    ry, rmean, rrstd = fused_norm._reference(x, g, b, 1e-5)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), ry.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(mean, rmean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rstd, rrstd, rtol=1e-5, atol=1e-5)


def _attn_inputs(bh, t, d, dtype, seed=3):
    rs = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rs.randn(bh, t, d).astype(np.float32))
                   .cuda().to(dtype) for _ in range(4))
    g_lse = torch.from_numpy(rs.randn(bh, t).astype(np.float32)).cuda()
    return q, k, v, do, g_lse


_FLASH_TOL = {torch.float32: (1e-5, 1e-5, 1e-4),      # o, lse, grads
              torch.bfloat16: (2e-2, 1e-4, 2e-2),
              torch.float16: (2e-2, 1e-4, 2e-2)}


_FLASH_SHAPES = (
    [(bh, t, d, dtype) for bh, t, d in ((4, 256, 64), (2, 200, 64),
                                        (3, 77, 128), (2, 64, 16),
                                        (1, 1, 32))
     for dtype in (torch.float32, torch.bfloat16, torch.float16)]
    + [(2, t, d, torch.bfloat16) for t in (1, 63, 64, 65, 127, 129, 200)
       for d in (16, 32, 64, 96, 128)]
    + [(2, t, d, torch.float16) for t in (1, 63, 64, 65, 200)
       for d in (16, 32, 64, 128)])


@pytest.mark.cuda
@pytest.mark.parametrize('bh,t,d,dtype', _FLASH_SHAPES)
@pytest.mark.parametrize('causal', [False, True, 'strict'])
def test_flash_kernels_match_plain_twins(bh, t, d, dtype, causal):
    _cuda()
    q, k, v, do, g_lse = _attn_inputs(bh, t, d, dtype)
    scale = 1.0 / np.sqrt(d)
    tol_o, tol_lse, tol_g = _FLASH_TOL[dtype]
    before = [kn.launches for kn in (fa.FWD_KERNEL, fa.DQ_KERNEL,
                                     fa.DKV_KERNEL)]
    o, lse = fa._fwd_cuda(q, k, v, causal, scale)
    ro, rlse = fa._reference_lse(q, k, v, causal, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), ro.to(dtype).float(), rtol=tol_o,
                               atol=tol_o)
    torch.testing.assert_close(lse, rlse, rtol=tol_lse, atol=tol_lse)
    # both backward kernels on the twin's (o, lse), with the g_lse fold
    delta = (do.float() * ro.to(dtype).float()).sum(-1) - g_lse
    args = (q, k, v, do, rlse, delta, causal, scale)
    dq = fa._bwd_dq_cuda(*args)
    dk, dv = fa._bwd_dkv_cuda(*args)
    rdq = fa._bwd_dq_reference(*args)
    rdk, rdv = fa._bwd_dkv_reference(*args)
    torch.cuda.synchronize()
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=tol_g,
                                   atol=tol_g)
    after = [kn.launches for kn in (fa.FWD_KERNEL, fa.DQ_KERNEL,
                                    fa.DKV_KERNEL)]
    assert after == [b + 1 for b in before]
    design = 'simt' if dtype == torch.float32 else 'mma'
    for kn in (fa.FWD_KERNEL, fa.DQ_KERNEL, fa.DKV_KERNEL):
        assert kn.variant_launches[design] >= 1


def _repeat_bit_for_bit(bh, t, d, causal, dtype):
    q, k, v, do, g_lse = _attn_inputs(bh, t, d, dtype, seed=6)
    scale = 1.0 / np.sqrt(d)
    runs = []
    for _ in range(2):
        o, lse = fa._fwd_cuda(q, k, v, causal, scale)
        delta = (do.float() * o.float()).sum(-1) - g_lse
        args = (q, k, v, do, lse, delta, causal, scale)
        runs.append((o, lse, fa._bwd_dq_cuda(*args),
                     *fa._bwd_dkv_cuda(*args)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize('bh,t,d,causal', [(16, 512, 64, True),
                                           (4, 300, 128, 'strict'),
                                           (6, 129, 32, False)])
def test_bf16_tensor_core_kernels_repeat_bit_for_bit(bh, t, d, causal):
    """No atomics: two launches of the forward, dq and dk/dv on the same
    inputs give the same bits."""
    _cuda()
    _repeat_bit_for_bit(bh, t, d, causal, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize('bh,t,d,causal', [(16, 512, 64, True),
                                           (4, 300, 128, 'strict'),
                                           (6, 129, 32, False)])
def test_f16_tensor_core_kernels_repeat_bit_for_bit(bh, t, d, causal):
    _cuda()
    _repeat_bit_for_bit(bh, t, d, causal, torch.float16)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_flash_kernels_take_more_heads_than_one_grid_holds(dtype):
    """B*H 65600 > 65535: the entry points launch two chunks of heads;
    every head, the last chunk's too, matches the twins."""
    _cuda()
    bh, t, d = 65600, 16, 32
    q, k, v, do, g_lse = _attn_inputs(bh, t, d, dtype, seed=19)
    scale = 1.0 / np.sqrt(d)
    tol_o, tol_lse, tol_g = _FLASH_TOL[dtype]
    o, lse = fa._fwd_cuda(q, k, v, True, scale)
    ro, rlse = fa._reference_lse(q, k, v, True, scale)
    delta = (do.float() * ro.to(dtype).float()).sum(-1) - g_lse
    args = (q, k, v, do, rlse, delta, True, scale)
    got = (o, fa._bwd_dq_cuda(*args), *fa._bwd_dkv_cuda(*args))
    want = (ro.to(dtype), fa._bwd_dq_reference(*args),
            *fa._bwd_dkv_reference(*args))
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, rlse, rtol=tol_lse, atol=tol_lse)
    for a, b, tol in zip(got, want, (tol_o, tol_g, tol_g, tol_g)):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
        assert float(a[-1].float().abs().max()) > 0   # the last chunk ran


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_strict_row_zero_is_zero_with_the_twins_lse(dtype):
    """Strict mode's row 0 sees no column: o = 0 exactly and lse the
    twin's -1e29 + log(1e-30), in every head."""
    _cuda()
    q, k, v, _, _ = _attn_inputs(5, 130, 64, dtype, seed=7)
    o, lse = fa._fwd_cuda(q, k, v, 'strict', 0.125)
    _, rlse = fa._reference_lse(q, k, v, 'strict', 0.125)
    torch.cuda.synchronize()
    assert float(o[:, 0].float().abs().max()) == 0.0
    assert torch.equal(lse[:, 0], rlse[:, 0])
    assert float(rlse[0, 0]) == np.float32(-1e29) + np.log(np.float32(1e-30))


@pytest.mark.cuda
def test_flash_bf16_takes_inputs_off_16_byte_alignment():
    """The tensor-core kernels copy 16 bytes at a time: a contiguous
    view that starts 2 bytes into its storage is copied to an aligned
    one by the wrapper, and the results match the twins."""
    _cuda()
    bh, t, d = 3, 70, 64
    q, k, v, do, _ = _attn_inputs(bh, t, d, torch.bfloat16, seed=8)
    views = []
    for x in (q, k, v, do):
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device='cuda')
        flat[1:].copy_(x.reshape(-1))
        views.append(flat[1:].view(bh, t, d))
    assert all(x.is_contiguous() and x.data_ptr() % 16 for x in views)
    o, lse = fa._fwd_cuda(*views[:3], True, 0.125)
    ro, rlse = fa._reference_lse(q, k, v, True, 0.125)
    delta = (do.float() * ro.to(torch.bfloat16).float()).sum(-1)
    dk, dv = fa._bwd_dkv_cuda(*views, rlse, delta, True, 0.125)
    rdk, rdv = fa._bwd_dkv_reference(q, k, v, do, rlse, delta, True, 0.125)
    dq = fa._bwd_dq_cuda(*views, rlse, delta, True, 0.125)
    rdq = fa._bwd_dq_reference(q, k, v, do, rlse, delta, True, 0.125)
    torch.cuda.synchronize()
    for got, want in ((o, ro.to(torch.bfloat16)), (dq, rdq), (dk, rdk),
                      (dv, rdv)):
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_flash_attention_autograd_on_the_card_matches_the_cpu():
    _cuda()
    q, k, v, do, g_lse = _attn_inputs(2, 130, 64, torch.float32, seed=5)
    outs = []
    for dev in ('cuda', 'cpu'):
        qs, ks, vs = (t.to(dev).clone().requires_grad_() for t in (q, k, v))
        o, lse = fa.flash_attention_lse(qs, ks, vs, True, None)
        torch.autograd.backward((o, lse), (do.to(dev), g_lse.to(dev)))
        outs.append([t.detach().cpu() for t in (o, lse, qs.grad, ks.grad,
                                                 vs.grad)])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_flash_kernels_refuse_what_they_do_not_take():
    _cuda()
    q, k, v, _, _ = _attn_inputs(2, 64, 8, torch.float32)
    with pytest.raises(ValueError, match='D % 16'):
        fa._fwd_cuda(q, k, v, True, 1.0)
    q, k, v, _, _ = _attn_inputs(2, 64, 64, torch.float64)
    with pytest.raises(TypeError):
        fa._fwd_cuda(q, k, v, True, 1.0)
    q, k, v, _, _ = _attn_inputs(2, 64, 64, torch.float32)
    with pytest.raises(ValueError, match='contiguous'):
        fa._fwd_cuda(q.transpose(0, 1), k.transpose(0, 1),
                     v.transpose(0, 1), True, 1.0)


_SM_TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -8,
           torch.float16: 2.0 ** -10}


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(64, 12, 128, 128), (4, 1024), (3, 200),
                                   (5, 1), (2, 3, 77), (2, 3000)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_softmax_kernel_matches_plain_twin(shape, dtype):
    _cuda()
    rs = np.random.RandomState(11)
    x = torch.from_numpy((3 * rs.randn(*shape)).astype(np.float32)) \
        .cuda().to(dtype)
    before = fsm.KERNEL.launches
    y = fsm._fwd_cuda(x, None)
    want = fsm._reference(x, None)
    torch.cuda.synchronize()
    assert fsm.KERNEL.launches == before + 1 and y.dtype == dtype
    torch.testing.assert_close(y.float(), want.float(), rtol=_SM_TOL[dtype],
                               atol=_SM_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize('x_shape,m_shape', [
    ((8, 12, 128, 128), (8, 1, 1, 128)), ((2, 3, 5, 200), (5, 200)),
    ((2, 3, 5, 7), (2, 3, 5, 1)), ((2, 3, 5, 7), (2, 3, 5, 7)),
    ((2, 2, 2, 2, 2, 3), (2, 1, 2, 1, 2, 3)), ((2, 1500), (1, 1500))])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_masked_softmax_kernel_matches_plain_twin(x_shape, m_shape, dtype):
    _cuda()
    rs = np.random.RandomState(12)
    x = torch.from_numpy((3 * rs.randn(*x_shape)).astype(np.float32)) \
        .cuda().to(dtype)
    mask = torch.from_numpy(np.where(rs.rand(*m_shape) < 0.3, -1e9, 0.0)
                            .astype(np.float32)).cuda()
    before = fsm.MASKED_KERNEL.launches
    y = fsm._fwd_cuda(x, mask)
    want = fsm._reference(x, mask)
    torch.cuda.synchronize()
    assert fsm.MASKED_KERNEL.launches == before + 1
    torch.testing.assert_close(y.float(), want.float(), rtol=_SM_TOL[dtype],
                               atol=_SM_TOL[dtype])


@pytest.mark.cuda
def test_softmax_autograd_on_the_card_matches_the_cpu():
    _cuda()
    rs = np.random.RandomState(13)
    x = torch.from_numpy(rs.randn(2, 3, 9, 40).astype(np.float32))
    mask = torch.from_numpy(rs.randn(2, 1, 1, 40).astype(np.float32))
    g = torch.from_numpy(rs.randn(2, 3, 9, 40).astype(np.float32))
    outs = []
    for dev in ('cuda', 'cpu'):
        xs, ms = (t.to(dev).clone().requires_grad_() for t in (x, mask))
        fsm.fused_softmax(xs, ms).backward(g.to(dev))
        outs.append([t.cpu() for t in (xs.grad, ms.grad)])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def _expected_softmax_design(h, dtype, offset):
    esize = torch.empty((), dtype=dtype).element_size()
    if h <= 1024 and h * esize % 16 == 0 and offset == 0:
        return 'vec'
    return 'scalar' if h <= 512 else 'block'


@pytest.mark.cuda
@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('offset', [0, 1])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize('h', [1, 31, 128, 200, 512, 1000, 1024, 1025,
                               4097])
def test_softmax_designs_match_twin_and_repeat(h, dtype, offset, masked):
    """Each design (vec, scalar, block) against the twin on 37 rows (not
    a whole number of a block's rows), x a view ``offset`` elements past
    16 bytes, with and without a padding-like mask; the wrapper names
    the design, and a second launch repeats the first bit for bit."""
    _cuda()
    rs = np.random.RandomState(h + offset)
    flat = torch.from_numpy((3 * rs.randn(offset + 2 * 37 * h))
                            .astype(np.float32)).cuda().to(dtype)
    x = flat[offset:].view(2, 37, h)
    mask = None
    if masked:
        mask = torch.from_numpy(np.where(rs.rand(2, 1, h) < 0.3, -1e9, 0.0)
                                .astype(np.float32)).cuda()
    kernel = fsm.MASKED_KERNEL if masked else fsm.KERNEL
    design = _expected_softmax_design(h, dtype, offset)
    before = dict(kernel.variant_launches)
    y = fsm._fwd_cuda(x, mask)
    want = fsm._reference(x, mask)
    torch.cuda.synchronize()
    assert kernel.variant_launches == {
        v: before[v] + (v == design) for v in fsm.VARIANTS}
    torch.testing.assert_close(y.float(), want.float(), rtol=_SM_TOL[dtype],
                               atol=_SM_TOL[dtype])
    assert torch.equal(fsm._fwd_cuda(x, mask), y)


@pytest.mark.cuda
@pytest.mark.parametrize('affine', [True, False])
@pytest.mark.parametrize('n', [1, 64, 8192])
@pytest.mark.parametrize('h', [1, 768, 770, 2048, 2049, 2560, 3001, 4097,
                               8192, 8193, 24577])
def test_layer_norm_designs_match_twin_and_repeat(h, n, affine):
    """Each design against the twin: warp up to H 2048 (one row a
    32-thread block), block above (128 threads to H 4096, 256 to 8192,
    1024 to 24576, the loop beyond; 3001 takes 8 groups a thread for its
    6), with and without gamma/beta, f32
    and bf16; a second launch repeats the first bit for bit."""
    _cuda()
    design = 'warp' if h <= 2048 else 'block'
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        x, g, b = _inputs(n, h, dtype, seed=h % 97)
        if not affine:
            g = b = None
        before = dict(fused_norm.KERNEL.variant_launches)
        y, mean, rstd = fused_norm._fwd_cuda(x, g, b, 1e-5)
        ry, rmean, rrstd = fused_norm._reference(x, g, b, 1e-5)
        torch.cuda.synchronize()
        assert fused_norm.KERNEL.variant_launches == {
            v: before[v] + (v == design) for v in fused_norm.VARIANTS}
        torch.testing.assert_close(y.float(), ry.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(mean, rmean, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(rstd, rrstd, rtol=1e-5, atol=1e-5)
        again = fused_norm._fwd_cuda(x, g, b, 1e-5)
        assert all(torch.equal(p, q) for p, q in zip((y, mean, rstd), again))


@pytest.mark.cuda
def test_layer_norm_without_grad_takes_the_kernel_alone():
    """Under no_grad the public function launches the kernel once and
    returns its y, in x's shape."""
    _cuda()
    x, g, b = _inputs(64, 768, torch.float32)
    before = fused_norm.KERNEL.variant_launches['warp']
    with torch.no_grad():
        y = fused_norm.fused_layer_norm(x.view(8, 8, 768), g, b)
    assert fused_norm.KERNEL.variant_launches['warp'] == before + 1
    assert y.shape == (8, 8, 768)
    torch.testing.assert_close(y.view(64, 768),
                               fused_norm._reference(x, g, b, 1e-5)[0],
                               rtol=1e-5, atol=1e-5)


def _gemm_inputs(m, k, n, dtype, seed=14):
    rs = np.random.RandomState(seed)
    x, dy = (torch.from_numpy(rs.randn(*s).astype(np.float32)).cuda()
             .to(dtype) for s in ((m, k), (m, n)))
    w = torch.from_numpy((0.05 * rs.randn(k, n)).astype(np.float32)) \
        .cuda().to(dtype)
    b = torch.from_numpy(rs.randn(n).astype(np.float32)).cuda()
    return x, w, b, dy


_GEMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize('m,k,n', [(1024, 768, 3072), (37, 53, 29),
                                   (128, 1, 130), (300, 129, 257)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize('approximate', [True, False])
def test_linear_gelu_kernels_match_plain_twins(m, k, n, dtype, approximate):
    _cuda()
    x, w, b, dy = _gemm_inputs(m, k, n, dtype)
    tol = _GEMM_TOL[dtype]
    before = (fgl.FWD_KERNEL.launches, fgl.BWD_KERNEL.launches)
    for bias in (b, None):
        y = fgl._fwd_cuda(x, w, bias, approximate)
        dz = fgl._bwd_cuda(x, w, bias, dy, approximate)
        ry = fgl._reference(x, w, bias, approximate)
        rdz = fgl._dz_reference(x, w, bias, dy, approximate)
        torch.cuda.synchronize()
        for got, want in ((y, ry), (dz, rdz)):
            assert got.dtype == dtype
            diff = (got.float() - want.float()).abs()
            assert bool((diff <= tol * (1 + want.float().abs())).all()), \
                float(diff.max())
    assert (fgl.FWD_KERNEL.launches, fgl.BWD_KERNEL.launches) == \
        (before[0] + 2, before[1] + 2)


@pytest.mark.cuda
def test_linear_gelu_autograd_on_the_card_matches_the_cpu():
    _cuda()
    x, w, b, dy = _gemm_inputs(70, 96, 50, torch.float32, seed=15)
    outs = []
    for dev in ('cuda', 'cpu'):
        xs, ws, bs = (t.to(dev).clone().requires_grad_() for t in (x, w, b))
        fgl.fused_linear_gelu(xs, ws, bs).backward(dy.to(dev))
        outs.append([t.cpu() for t in (xs.grad, ws.grad, bs.grad)])
    for a, c in zip(*outs):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_new_kernels_refuse_what_they_do_not_take():
    _cuda()
    x = torch.zeros((4, 8), dtype=torch.float64, device='cuda')
    with pytest.raises(TypeError):
        fsm._fwd_cuda(x, None)
    with pytest.raises(ValueError, match='contiguous'):
        fsm._fwd_cuda(torch.zeros((8, 4), device='cuda').t(), None)
    xf, w, b, _ = _gemm_inputs(4, 8, 6, torch.float32)
    with pytest.raises(TypeError, match='one dtype'):
        fgl._fwd_cuda(xf, w.to(torch.bfloat16), b, True)
    with pytest.raises(ValueError, match='contiguous'):
        fgl._fwd_cuda(xf, w.t().contiguous().t(), b, True)


# (M, K, N) of the tensor-core design's edge cases: M 129 and 8191 (one
# row past a 128-row tile, one short of 64 tiles), N 136 and 3000 (past
# 128, short of 12 x 256), K 8, 64, 72 and 776 (below, at and past a
# 64-deep slice; past 12 slices)
_TC_SHAPES = [(129, 64, 136), (129, 72, 3000), (8191, 776, 136),
              (8191, 8, 3000), (129, 776, 3000), (8191, 64, 136),
              (129, 8, 136), (8191, 72, 3000)]


def _tensor_core_matches_twins_and_repeats(m, k, n, approximate, dtype):
    x, w, b, dy = _gemm_inputs(m, k, n, dtype, seed=16)
    assert fgl.tensor_core_route(x, w)
    before = [dict(kn.variant_launches)
              for kn in (fgl.FWD_KERNEL, fgl.BWD_KERNEL)]
    for bias in (b, None):
        y = fgl._fwd_cuda(x, w, bias, approximate)
        dz = fgl._bwd_cuda(x, w, bias, dy, approximate)
        ry = fgl._reference(x, w, bias, approximate)
        rdz = fgl._dz_reference(x, w, bias, dy, approximate)
        torch.cuda.synchronize()
        for got, want in ((y, ry), (dz, rdz)):
            assert got.dtype == dtype
            diff = (got.float() - want.float()).abs()
            assert bool((diff <= 2e-2 * (1 + want.float().abs())).all()), \
                float(diff.max())
        # no atomics: a second launch repeats the first bit for bit
        assert torch.equal(fgl._fwd_cuda(x, w, bias, approximate), y)
        assert torch.equal(fgl._bwd_cuda(x, w, bias, dy, approximate), dz)
    for kn, was in zip((fgl.FWD_KERNEL, fgl.BWD_KERNEL), before):
        assert kn.variant_launches == {'tensor_core': was['tensor_core'] + 4,
                                       'simt': was['simt']}


@pytest.mark.cuda
@pytest.mark.parametrize('m,k,n', _TC_SHAPES)
@pytest.mark.parametrize('approximate', [True, False])
def test_tensor_core_linear_gelu_matches_twins_and_repeats(m, k, n,
                                                           approximate):
    _cuda()
    _tensor_core_matches_twins_and_repeats(m, k, n, approximate,
                                           torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize('m,k,n', _TC_SHAPES[:4])
@pytest.mark.parametrize('approximate', [True, False])
def test_f16_tensor_core_linear_gelu_matches_twins_and_repeats(
        m, k, n, approximate):
    """The .f16 form of the wgmma, fed by FLOAT16 tensor maps."""
    _cuda()
    _tensor_core_matches_twins_and_repeats(m, k, n, approximate,
                                           torch.float16)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,k,n', [(torch.float32, 16, 8),
                                       (torch.bfloat16, 12, 20)])
def test_simt_linear_gelu_launches_rows_past_one_grid_in_chunks(dtype, k,
                                                                 n):
    """M = 65535 * 128 + 1000 rows is more than one SIMT grid holds: the
    entry point launches two chunks, and the rows of both match the
    twins."""
    _cuda()
    m = 65535 * 128 + 1000
    x, w, b, dy = _gemm_inputs(m, k, n, dtype, seed=20)
    assert not fgl.tensor_core_route(x, w)
    tol = _GEMM_TOL[dtype]
    for got, want in ((fgl._fwd_cuda(x, w, b, True),
                       fgl._reference(x, w, b, True)),
                      (fgl._bwd_cuda(x, w, b, dy, True),
                       fgl._dz_reference(x, w, b, dy, True))):
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        assert bool((diff <= tol * (1 + want.float().abs())).all()), \
            float(diff.max())
        assert float(got[-1000:].float().abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize('m,k,n,dtype,design', [
    (1024, 768, 3072, torch.bfloat16, 'tensor_core'),
    (37, 53, 29, torch.bfloat16, 'simt'), (300, 129, 256, torch.bfloat16,
                                            'simt'),
    (64, 64, 257, torch.bfloat16, 'simt'),
    (1024, 768, 3072, torch.float32, 'simt'),
    (1024, 768, 3072, torch.float16, 'tensor_core'),
    (37, 53, 29, torch.float16, 'simt')])
def test_linear_gelu_takes_the_design_its_route_names(m, k, n, dtype, design):
    """bf16 with K and N multiples of 8 launches the tensor-core kernels;
    unaligned bf16 (K 53 or 129, N 29 or 257) and f32 the SIMT ones."""
    _cuda()
    x, w, b, dy = _gemm_inputs(m, k, n, dtype, seed=17)
    before = [dict(kn.variant_launches)
              for kn in (fgl.FWD_KERNEL, fgl.BWD_KERNEL)]
    fgl._fwd_cuda(x, w, b, True)
    fgl._bwd_cuda(x, w, b, dy, True)
    torch.cuda.synchronize()
    for kn, was in zip((fgl.FWD_KERNEL, fgl.BWD_KERNEL), before):
        want = dict(was)
        want[design] += 1
        assert kn.variant_launches == want


@pytest.mark.cuda
def test_tensor_core_linear_gelu_takes_views_off_16_bytes():
    """TMA needs 16-byte-aligned bases: contiguous views that start 2
    bytes into their storage are copied by the wrapper, and the results
    match the twins."""
    _cuda()
    x, w, b, dy = _gemm_inputs(200, 72, 136, torch.bfloat16, seed=18)
    views = []
    for t in (x, w, dy):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device='cuda')
        flat[1:].copy_(t.reshape(-1))
        views.append(flat[1:].view(t.shape))
    assert all(v.is_contiguous() and v.data_ptr() % 16 for v in views)
    vx, vw, vdy = views
    before = fgl.FWD_KERNEL.variant_launches['tensor_core']
    y = fgl._fwd_cuda(vx, vw, b, True)
    dz = fgl._bwd_cuda(vx, vw, b, vdy, True)
    torch.cuda.synchronize()
    assert fgl.FWD_KERNEL.variant_launches['tensor_core'] == before + 1
    for got, want in ((y, fgl._reference(x, w, b, True)),
                      (dz, fgl._dz_reference(x, w, b, dy, True))):
        diff = (got.float() - want.float()).abs()
        assert bool((diff <= 2e-2 * (1 + want.float().abs())).all())
