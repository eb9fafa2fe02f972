"""The port's fused softmax against the JAX package's, on the CPU.

The same numpy-seeded inputs go through the reference's Pallas kernels
(``_sm``, plain and masked) in TPU-interpret mode and through the
port's ``fused_softmax`` on CPU tensors, which runs the plain twin of
the CUDA kernels.  The CUDA kernels index a broadcast mask through
strides (``_mask_meta``); that index arithmetic is checked here against
the materialised broadcast, since the kernels themselves run only on
the card (``tests/test_torch_cuda_kernels.py``).

Tolerances: f32 1e-6 on y (one exp and one division per element, sums
of at most 256 terms in another order); bf16 2^-8 absolute (both round
an f32 value below 1 to bf16, and the f32 values may differ in the last
bits); gradients 1e-6 in f32 (the same algebra, ``y * (g - sum(g *
y))``, in both), and 1e-5 on a mask gradient summed over 8 broadcast
rows.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from paddle_tpu_torch import amp
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import fused_softmax

jsm = importlib.import_module('paddle_tpu.ops.fused_softmax')
psm = importlib.import_module('paddle_tpu_torch.ops.fused_softmax')

TOL = 1e-6
BF16_TOL = 2.0 ** -8
GRAD_TOL = 1e-6


def _rand(*shape, seed=0, scale=3.0):
    return (scale * np.random.RandomState(seed).randn(*shape)) \
        .astype(np.float32)


def _padding_mask(b, t, seed=1):
    """``[b, 1, 1, t]`` additive mask: 0 on the kept prefix of each
    sequence, -1e9 on its padding."""
    lens = np.random.RandomState(seed).randint(t // 4, t + 1, (b,))
    keep = np.arange(t)[None, :] < lens[:, None]
    return np.where(keep, 0.0, -1e9).astype(np.float32)[:, None, None, :]


def _close(got, want, tol, what=''):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize('h', [128, 256])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_forward_matches_the_pallas_kernel(h, dtype):
    x = _rand(16, h)
    jx = jnp.asarray(x).astype(dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jsm._sm(jx, None, 8)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = fused_softmax(tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           TOL if dtype == 'float32' else BF16_TOL)


@pytest.mark.parametrize('h', [128, 256])
def test_masked_forward_matches_the_pallas_kernel(h):
    """A padding mask ``[B, 1, 1, T]`` over ``[B, H, T, T]`` scores:
    the port takes it as it is, the reference broadcasts it first."""
    b, nh = 2, 2
    x = _rand(b, nh, h, h, seed=2)
    mask = _padding_mask(b, h)
    m2d = np.broadcast_to(mask, x.shape).reshape(-1, h)
    with pltpu.force_tpu_interpret_mode():
        want = jsm._sm(jnp.asarray(x.reshape(-1, h)), jnp.asarray(m2d), 8)
    got = fused_softmax(torch.from_numpy(x), torch.from_numpy(mask))
    _close(got.numpy().reshape(-1, h), np.asarray(want), TOL)
    # padded columns get exactly 0, kept rows sum to 1
    assert float(got.numpy().reshape(-1, h)[m2d < 0].max()) == 0.0
    _close(got.sum(-1).numpy(), np.ones((b, nh, h)), 1e-5)


def test_gradients_match_jax_vjp_through_the_pallas_kernel():
    x = _rand(4, 8, 128, seed=3)
    mask = (_rand(4, 1, 128, seed=4, scale=1.0) > 0.5) * -1e4
    mask = mask.astype(np.float32)
    g = _rand(4, 8, 128, seed=5, scale=1.0)

    def f(a, m):
        m2d = jnp.broadcast_to(m, a.shape).reshape(-1, 128)
        return jsm._sm(a.reshape(-1, 128), m2d, 8).reshape(a.shape)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(mask))
        wdx, wdm = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tm = torch.from_numpy(mask).requires_grad_()
    fused_softmax(tx, tm).backward(torch.from_numpy(g))
    _close(tx.grad.numpy(), np.asarray(wdx), GRAD_TOL, 'dx')
    assert tm.grad.shape == tm.shape
    _close(tm.grad.numpy(), np.asarray(wdm), 1e-5, 'dmask')


def test_unmasked_gradient_matches_jax_grad():
    """The reference's own check (tests/test_ops_kernels.py): grad of
    ``sum(y ** 3)``."""
    x = _rand(8, 128, seed=11, scale=1.0)
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(lambda a: jnp.sum(jsm._sm(a, None, 8) ** 3))(
            jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    (fused_softmax(tx) ** 3).sum().backward()
    _close(tx.grad.numpy(), np.asarray(want), GRAD_TOL)


@pytest.mark.parametrize('shape', [(3, 5, 200), (7, 1), (2, 1500)])
def test_ragged_rows_match_the_reference_function(shape):
    """Row lengths no TPU block takes (the CUDA kernels take any h; rows
    past 1024 go to the block-per-row kernel) against the reference's
    plain ``_reference`` and ``jax.grad`` through it."""
    x = _rand(*shape, seed=6)
    mask = _rand(shape[-1], seed=7, scale=1.0)
    g = _rand(*shape, seed=8, scale=1.0)
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        want, vjp = jax.vjp(lambda a: jsm._reference(a, jm), jnp.asarray(x))
        tx = torch.from_numpy(x).requires_grad_()
        got = fused_softmax(tx, None if m is None else torch.from_numpy(m))
        _close(got.detach().numpy(), np.asarray(want), TOL)
        got.backward(torch.from_numpy(g))
        _close(tx.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
               GRAD_TOL)


def _gather_by_meta(mask_f32, meta, n, h):
    """The CUDA kernel's mask indexing (``mask_row`` + ``c * sh``),
    written out over the mask's storage."""
    d1, d2, d3, s0, s1, s2, s3, sh = list(meta)
    flat = mask_f32.as_strided((mask_f32.untyped_storage().nbytes() // 4,),
                               (1,), 0)
    base = mask_f32.storage_offset()
    out = torch.empty((n, h))
    for r in range(n):
        i3, rest = r % d3, r // d3
        i2, rest = rest % d2, rest // d2
        i1, i0 = rest % d1, rest // d1
        off = base + i0 * s0 + i1 * s1 + i2 * s2 + i3 * s3
        out[r] = flat[off + torch.arange(h) * sh]
    return out


@pytest.mark.parametrize('x_shape,m_shape', [
    ((2, 3, 5, 7), (2, 1, 1, 7)),       # padding mask
    ((2, 3, 5, 7), (5, 7)),             # one mask for every batch, head
    ((2, 3, 5, 7), (2, 3, 5, 1)),       # broadcast along the row
    ((2, 3, 5, 7), (2, 3, 5, 7)),       # full
    ((2, 2, 2, 2, 2, 3), (2, 1, 2, 1, 2, 3)),   # > 4 dims that stay apart
    ((4, 6), (1, 6))])
def test_mask_strides_index_the_broadcast(x_shape, m_shape):
    rs = np.random.RandomState(9)
    mask = torch.from_numpy(rs.randn(*m_shape).astype(np.float32))
    m, meta = psm._mask_meta(mask, x_shape)
    n, h = int(np.prod(x_shape[:-1])), x_shape[-1]
    want = mask.expand(x_shape).reshape(n, h)
    assert torch.equal(_gather_by_meta(m, meta, n, h), want)
    if m_shape != x_shape and len(x_shape) <= 5:
        # a broadcast mask is never copied to x's shape
        assert m.untyped_storage().nbytes() == mask.numel() * 4


def test_mask_of_another_dtype_is_read_as_f32():
    x = _rand(2, 4, 16)
    mask = _padding_mask(2, 16)[:, 0]                       # [2, 1, 16]
    got = fused_softmax(torch.from_numpy(x),
                        torch.from_numpy(mask).to(torch.bfloat16))
    want = jsm._reference(jnp.asarray(x),
                          jnp.asarray(mask).astype(jnp.bfloat16))
    _close(got.numpy(), np.asarray(want), TOL)


def test_softmax_functional_routes_the_last_axis_to_the_kernel(monkeypatch):
    calls = []
    real = psm._fwd
    monkeypatch.setattr(psm, '_fwd',
                        lambda x, m: calls.append(x.shape) or real(x, m))
    x = torch.from_numpy(_rand(2, 3, 8, seed=12))
    for axis in (-1, 2):
        _close(F.softmax(x, axis=axis).numpy(),
               torch.softmax(x, dim=-1).numpy(), TOL)
    assert calls == [(2, 3, 8)] * 2
    _close(F.softmax(x, axis=1).numpy(), torch.softmax(x, 1).numpy(), TOL)
    assert len(calls) == 2
    # black-listed under AMP: a bf16 input comes out as f32
    with amp.auto_cast(level='O2'):
        assert F.softmax(x.to(torch.bfloat16)).dtype == torch.float32
        assert F.tanh(x).dtype == torch.bfloat16
    _close(F.tanh(x).numpy(), np.tanh(x.numpy()), TOL)


def test_bad_arguments_raise():
    x = torch.zeros(2, 4)
    for bad in (0, -8, 1.5, True):
        with pytest.raises(ValueError, match='block_rows'):
            fused_softmax(x, block_rows=bad)
    assert torch.equal(fused_softmax(x, block_rows=8), fused_softmax(x))
    with pytest.raises(ValueError, match='broadcast'):
        fused_softmax(x, torch.zeros(3, 4))
    with pytest.raises(ValueError, match='at least one axis'):
        fused_softmax(torch.zeros(()))
    with pytest.raises(ValueError, match='no kernel for device'):
        fused_softmax(torch.empty((2, 4), device='meta'))


def test_kernels_are_registered_with_their_tpu_counterparts():
    assert psm.KERNEL.name == 'fused_softmax'
    assert psm.MASKED_KERNEL.name == 'fused_softmax_masked'
    assert psm.KERNEL.replaces == 'paddle_tpu/ops/fused_softmax.py:26'
    assert psm.MASKED_KERNEL.replaces == 'paddle_tpu/ops/fused_softmax.py:33'
    for kn in (psm.KERNEL, psm.MASKED_KERNEL):
        assert kn.route == 'cuda'
        assert kn.source_path == 'paddle_tpu_torch/csrc/fused_softmax.cu'


@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('dtype,code', [(torch.float32, 0),
                                        (torch.bfloat16, 1),
                                        (torch.float16, 2)])
def test_each_dtype_reaches_the_kernel_launch_with_its_code(
        monkeypatch, masked, dtype, code):
    """float16 reaches both kernels' launches with code 2 (the entry
    points stubbed: no card here)."""
    kernel = psm.MASKED_KERNEL if masked else psm.KERNEL
    seen = []
    monkeypatch.setattr(kernel, '_fn', lambda *a: seen.append(a) or 0)
    monkeypatch.setattr(psm, 'stream', lambda device: 7)
    x = torch.zeros((2, 3, 5, 40), dtype=dtype)
    mask = torch.from_numpy(_padding_mask(2, 40)) if masked else None
    before = kernel.launches
    y = psm._fwd_cuda(x, mask)
    args, = seen
    assert y.dtype == dtype and y.shape == x.shape
    assert args[-2:] == (code, 7)
    assert args[(3 if masked else 2):(5 if masked else 4)] == (30, 40)
    assert kernel.launches == before + 1


def test_f16_matches_the_pallas_kernel():
    """The twin in float16 against the Pallas kernel in interpret mode
    on the same f16 inputs: both compute in f32 and round to f16 (one
    f16 step below 1 is at most 2^-11; the bound is twice that)."""
    x = _rand(8, 128, seed=6).astype(np.float16)
    with pltpu.force_tpu_interpret_mode():
        want = jsm._sm(jnp.asarray(x), None, 8)
    got = fused_softmax(torch.from_numpy(x))
    assert got.dtype == torch.float16
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           2.0 ** -10)
