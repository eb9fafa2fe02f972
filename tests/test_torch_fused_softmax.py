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
    # code, then the design (40 columns: 'vec' for 2- and 4-byte types)
    assert args[-3:] == (code, psm.VARIANTS.index('vec'), 7)
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


# The CUDA kernels' arithmetic (csrc/fused_softmax.cu): e = exp2((t - max)
# * log2(e)) with the constant rounded to f32, each lane's sum over its
# elements in the order it holds them, the lanes' sums combined by an xor
# butterfly, one reciprocal of the row's sum, y = e * r.  The vec design:
# LANES lanes a row (the next power of two to the row's 16-byte vectors,
# at most 32), lane l holding vectors j * LANES + l of 16 / itemsize
# elements; the scalar design: 32 lanes, lane l holding columns 32 i + l.
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def _lanes_of(design, h, itemsize):
    """(lanes a row, [per lane: its columns in the order it sums them])."""
    if design == 'scalar':
        return 32, [list(range(lane, h, 32)) for lane in range(32)]
    vw = 16 // itemsize
    nvec = h // vw
    lanes = 1
    while lanes < 32 and lanes < nvec:
        lanes *= 2
    return lanes, [[q * vw + k for q in range(lane, nvec, lanes)
                    for k in range(vw)] for lane in range(lanes)]


def _replay(x2d, design):
    """The kernel's forward for ``design`` ('vec' or 'scalar') on the
    CPU, in f32, rounded to x's dtype at the end."""
    t = x2d.float()
    e = torch.exp2((t - t.max(dim=-1, keepdim=True).values) * LOG2E)
    lanes, cols = _lanes_of(design, t.shape[-1], x2d.element_size())
    part = torch.zeros((t.shape[0], lanes), dtype=torch.float32)
    for lane, order in enumerate(cols):
        for c in order:                 # s += e, one f32 add at a time
            part[:, lane] = part[:, lane] + e[:, c]
    idx = torch.arange(lanes)
    o = lanes // 2
    while o:                            # __shfl_xor_sync butterfly
        part = part + part[:, idx ^ o]
        o //= 2
    r = torch.ones(()) / part[:, :1]
    return (e * r).to(x2d.dtype)


@pytest.mark.parametrize('h', [128, 1000, 1024])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16', 'float16'])
def test_kernel_arithmetic_replayed_matches_twin_and_pallas(h, dtype):
    """The designs' arithmetic, replayed, within half the card's
    tolerance (f32 1e-6, bf16 2^-8, f16 2^-10, each times 1 + |want|) of
    the plain twin and of the Pallas kernel in interpret mode."""
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(_rand(16, h, seed=h)).to(tdt)
    xs = tx.float().numpy()             # the rounded values, exactly
    tol = {'float32': TOL, 'bfloat16': BF16_TOL,
           'float16': 2.0 ** -10}[dtype] / 2
    with pltpu.force_tpu_interpret_mode():
        pallas = jsm._sm(jnp.asarray(xs).astype(dtype), None, 8)
    wants = {'twin': psm._reference(tx, None).float(),
             'pallas': torch.from_numpy(
                 np.array(pallas.astype(jnp.float32)))}
    # the scalar design takes rows up to 512 columns
    for design in ('vec', 'scalar') if h <= 512 else ('vec',):
        got = _replay(tx, design)
        assert got.dtype == tdt
        for name, want in wants.items():
            diff = (got.float() - want).abs()
            assert bool((diff <= tol * (1 + want.abs())).all()), \
                (design, name, float(diff.max()))


def test_replayed_lanes_cover_each_column_once():
    """The replay's lane map holds every column exactly once, in the
    order the kernel's loops visit it."""
    for design, h, size in (('vec', 1024, 4), ('vec', 128, 2),
                            ('vec', 40, 4), ('vec', 8, 2),
                            ('scalar', 500, 4), ('scalar', 7, 2)):
        lanes, cols = _lanes_of(design, h, size)
        flat = sorted(c for order in cols for c in order)
        assert flat == list(range(h)), (design, h, size)
        assert lanes == len(cols) and lanes & (lanes - 1) == 0
    assert _lanes_of('vec', 128, 2)[0] == 16     # 16 vectors of 8 bf16
    assert _lanes_of('vec', 1024, 4)[1][1][:5] == [4, 5, 6, 7, 132]


# (h, dtype, offset in elements of x's view, design): rows up to 1024
# columns whose bytes are a multiple of 16 on 16-byte pointers take 'vec',
# other rows up to 512 'scalar', the rest 'block'
_DESIGN_CASES = [
    (128, torch.float32, 0, 'vec'), (1024, torch.float32, 0, 'vec'),
    (200, torch.float32, 0, 'vec'), (4, torch.float32, 0, 'vec'),
    (1000, torch.bfloat16, 0, 'vec'), (128, torch.float16, 0, 'vec'),
    (8, torch.bfloat16, 0, 'vec'),
    (199, torch.float32, 0, 'scalar'), (510, torch.float32, 0, 'scalar'),
    (4, torch.bfloat16, 0, 'scalar'), (1, torch.float32, 0, 'scalar'),
    (128, torch.float32, 1, 'scalar'), (512, torch.float16, 1, 'scalar'),
    (1022, torch.float32, 0, 'block'), (1020, torch.bfloat16, 0, 'block'),
    (1024, torch.float16, 1, 'block'), (513, torch.float32, 0, 'block'),
    (1025, torch.float32, 0, 'block'), (4096, torch.float32, 0, 'block'),
    (4096, torch.float32, 1, 'block'), (4097, torch.bfloat16, 0, 'block')]


@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('h,dtype,offset,design', _DESIGN_CASES)
def test_wrapper_picks_the_design_for_the_row(monkeypatch, masked, h, dtype,
                                              offset, design):
    """The wrapper names the design before the launch and passes its code
    (the entry points stubbed: no card here)."""
    kernel = psm.MASKED_KERNEL if masked else psm.KERNEL
    seen = []
    monkeypatch.setattr(kernel, 'launch',
                        lambda *a, variant=None: seen.append((a, variant)))
    monkeypatch.setattr(psm, 'stream', lambda device: 7)
    flat = torch.zeros(offset + 3 * h, dtype=dtype)
    x = flat[offset:].view(3, h)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    mask = torch.zeros(h) if masked else None
    psm._fwd_cuda(x, mask)
    (args, variant), = seen
    assert variant == design
    assert args[-2] == psm.VARIANTS.index(design)
    assert psm.design(x, torch.empty_like(x)) == design
