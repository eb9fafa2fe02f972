"""The port's fused matmul + bias + GELU against the JAX package's, on
the CPU.

The same numpy-seeded x, w, b go through the reference's Pallas kernels
(``_fused``, forward and recompute backward) in TPU-interpret mode and
through the port's ``fused_linear_gelu`` on CPU tensors, which runs the
plain twins of the CUDA kernels (``_reference`` and ``_dz_reference``).
Shapes as the reference's own tests take them (``tests/
test_ops_kernels.py``): ``(256, 512) x (512, 256)`` in one block, and
``(512, 1024) x (1024, 512)`` over a multi-block grid.

Tolerances: forward 2e-5 (f32; a 512- or 1024-term product in another
order, then the same GELU formula); gradients of ``sum(y ** 2)`` 1e-4
relative to each gradient's largest entry (the 256- to 512-term
products of the backward, in another order); ragged shapes against the
reference's jnp ``_reference`` 1e-5.  ``mlp_gelu`` with the switch on
against off: 1e-5 on values and 1e-4 on gradients (``torch``'s own
tanh-GELU against the kernels' formula).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from paddle_tpu_torch import amp
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import functional as F

jfg = importlib.import_module('paddle_tpu.ops.fused_gelu_linear')
pfg = importlib.import_module('paddle_tpu_torch.ops.fused_gelu_linear')

FWD_TOL = 2e-5
GRAD_RTOL = 1e-4
RAGGED_TOL = 1e-5


def _inputs(m, k, n, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(m, k).astype(np.float32),
            (0.05 * rs.randn(k, n)).astype(np.float32),
            rs.randn(n).astype(np.float32))


def _close(got, want, tol, what=''):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _close_rel(got, want, rtol, what=''):
    """max |got - want| within ``rtol`` of max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize('approximate', [True, False])
@pytest.mark.parametrize('m,k,n', [(256, 512, 256), (512, 1024, 512)])
def test_forward_matches_the_pallas_kernel(m, k, n, approximate):
    x, w, b = _inputs(m, k, n)
    with pltpu.force_tpu_interpret_mode():
        want = jfg._fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          approximate, (256, 256, 512))
    got = pfg.fused_linear_gelu(*map(torch.from_numpy, (x, w, b)),
                                approximate=approximate)
    assert got.shape == (m, n) and got.dtype == torch.float32
    _close(got.numpy(), want, FWD_TOL)


@pytest.mark.parametrize('approximate', [True, False])
def test_gradients_match_jax_grad_through_the_pallas_kernels(approximate):
    x, w, b = _inputs(256, 512, 256, seed=1)

    def loss(a, c, d):
        return jnp.sum(jfg._fused(a, c, d, approximate, (256, 256, 512))
                       ** 2)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    (pfg.fused_linear_gelu(tx, tw, tb, approximate) ** 2).sum().backward()
    for name, got, ref in zip('xwb', (tx.grad, tw.grad, tb.grad), want):
        _close_rel(got.numpy(), ref, GRAD_RTOL, f'd{name}')


@pytest.mark.parametrize('with_bias', [True, False])
def test_ragged_shape_matches_the_reference_function(with_bias):
    """M, K, N that no TPU block divides (the CUDA kernels mask the
    ragged tiles), with and without a bias, against the reference's
    jnp ``_reference`` and ``jax.grad`` through it."""
    x, w, b = _inputs(37, 53, 29, seed=2)
    x = x.reshape(1, 37, 53)
    jb = jnp.asarray(b) if with_bias else None
    for approximate in (True, False):
        def loss(a, c, d):
            return jnp.sum(jfg._reference(a, c, d, approximate) ** 2)

        want = jfg._reference(jnp.asarray(x), jnp.asarray(w), jb,
                              approximate)
        grads = jax.grad(loss, argnums=(0, 1, 2) if with_bias else (0, 1))(
            jnp.asarray(x), jnp.asarray(w), jb)
        tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
        tb = torch.from_numpy(b).requires_grad_() if with_bias else None
        got = pfg.fused_linear_gelu(tx, tw, tb, approximate)
        assert got.shape == (1, 37, 29)
        _close(got.detach().numpy(), want, RAGGED_TOL)
        (got ** 2).sum().backward()
        mine = (tx.grad, tw.grad) + ((tb.grad,) if with_bias else ())
        for name, g, ref in zip('xwb', mine, grads):
            _close_rel(g.numpy(), ref, GRAD_RTOL, f'd{name}')


def test_backward_twin_is_autograd_through_the_forward_twin():
    """``_dz_reference`` (the backward kernel's function) against torch
    autograd of ``_reference`` with respect to the pre-activation."""
    x, w, b = (torch.from_numpy(a) for a in _inputs(33, 40, 24, seed=3))
    dy = torch.from_numpy(np.random.RandomState(4).randn(33, 24)
                          .astype(np.float32))
    for approximate in (True, False):
        z = (x @ w + b).requires_grad_()
        pfg._gelu_f32(z, approximate).backward(dy)
        got = pfg._dz_reference(x, w, b, dy, approximate)
        _close(got.numpy(), z.grad.numpy(), 1e-6)


def test_bf16_inputs_keep_bf16_and_accumulate_in_f32():
    x, w, b = _inputs(16, 64, 32, seed=5)
    tx, tw = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
              for a in (x, w))
    tb = torch.from_numpy(b).to(torch.bfloat16).requires_grad_()
    y = pfg.fused_linear_gelu(tx, tw, tb)
    assert y.dtype == torch.bfloat16
    # the product of the bf16 operands in f32, bias and GELU in f32,
    # then one rounding
    want = pfg._gelu_f32(tx.detach().float() @ tw.detach().float()
                         + tb.detach().float(), True).to(torch.bfloat16)
    assert torch.equal(y.detach(), want)
    y.float().sum().backward()
    assert (tx.grad.dtype, tw.grad.dtype, tb.grad.dtype) == \
        (torch.bfloat16,) * 3
    # mixed dtypes are promoted to one
    assert pfg.fused_linear_gelu(tx.detach().float(), tw.detach(),
                                 None).dtype == torch.float32


def test_mlp_gelu_switch_on_matches_off(monkeypatch):
    torch.manual_seed(0)
    fc = Linear(32, 64, device='cpu')
    fc.reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():
        fc.bias.normal_(generator=torch.Generator().manual_seed(2))
    xv = torch.from_numpy(np.random.RandomState(0).randn(4, 5, 32)
                          .astype(np.float32))
    results = []
    calls = []
    real = pfg._fwd
    monkeypatch.setattr(pfg, '_fwd', lambda *a: calls.append(1) or real(*a))
    for on in (True, False):
        monkeypatch.setattr(pfg, 'USE_PALLAS_MLP', on)
        fc.zero_grad()
        x = xv.clone().requires_grad_()
        y = pfg.mlp_gelu(x, fc)
        (y * y).sum().backward()
        results.append((y.detach(), x.grad, fc.weight.grad.clone(),
                        fc.bias.grad.clone()))
    assert calls == [1]                       # the kernel path only when on
    _close(results[0][0].numpy(), results[1][0].numpy(), 1e-5)
    for a, c in zip(results[0][1:], results[1][1:]):
        _close_rel(a.numpy(), c.numpy(), GRAD_RTOL)
    # AMP: 'fused_linear_gelu' is white-listed, the parameters stay f32
    monkeypatch.setattr(pfg, 'USE_PALLAS_MLP', True)
    with amp.auto_cast(level='O1'):
        assert pfg.mlp_gelu(xv, fc).dtype == torch.bfloat16
    assert fc.weight.dtype == torch.float32
    _close(F.gelu(xv, approximate=True).numpy(),
           pfg._gelu_f32(xv, True).numpy(), 1e-6)


def test_bad_arguments_raise():
    x, w, b = (torch.from_numpy(a) for a in _inputs(4, 8, 6))
    with pytest.raises(ValueError, match='bias'):
        pfg._checked(x, w, b[:5])
    with pytest.raises(ValueError, match=r'\[K, N\]'):
        pfg._checked(x, w[:7], b)
    with pytest.raises(TypeError, match='one dtype'):
        pfg._checked(x, w.to(torch.bfloat16), b)
    with pytest.raises(ValueError, match='contiguous'):
        pfg._checked(x.t().contiguous().t(), w, b)
    with pytest.raises(ValueError, match='no kernel for device'):
        pfg.fused_linear_gelu(torch.empty((2, 8), device='meta'),
                              torch.empty((8, 6), device='meta'), None)


def test_kernels_are_registered_with_their_tpu_counterparts():
    assert pfg.FWD_KERNEL.name == 'fused_linear_gelu_fwd'
    assert pfg.BWD_KERNEL.name == 'fused_linear_gelu_bwd'
    assert pfg.FWD_KERNEL.replaces == 'paddle_tpu/ops/fused_gelu_linear.py:72'
    assert pfg.BWD_KERNEL.replaces == 'paddle_tpu/ops/fused_gelu_linear.py:84'
    for kn in (pfg.FWD_KERNEL, pfg.BWD_KERNEL):
        assert kn.route == 'cuda'
        assert kn.source_path == 'paddle_tpu_torch/csrc/fused_gelu_linear.cu'
    assert pfg.USE_PALLAS_MLP is False and jfg.USE_PALLAS_MLP is False


@pytest.mark.parametrize('dtype,k,n,want', [
    (torch.bfloat16, 768, 3072, True), (torch.bfloat16, 8, 136, True),
    (torch.bfloat16, 776, 3000, True), (torch.bfloat16, 53, 29, False),
    (torch.bfloat16, 129, 256, False), (torch.bfloat16, 64, 257, False),
    (torch.float32, 768, 3072, False), (torch.float16, 768, 3072, True),
    (torch.float16, 53, 29, False)])
def test_tensor_core_route_by_dtype_and_shape(dtype, k, n, want):
    """bf16 with K and N multiples of 8 (16-byte rows for TMA) takes the
    tensor-core design; f32 and other bf16 shapes take the SIMT one."""
    x = torch.zeros((3, k), dtype=dtype)
    w = torch.zeros((k, n), dtype=dtype)
    assert pfg.tensor_core_route(x, w) is want


def test_alignment_copy_only_for_views_off_16_bytes():
    flat = torch.arange(1 + 4 * 64, dtype=torch.float32).to(torch.bfloat16)
    aligned = flat[:-1].view(4, 64)
    off = flat[1:].view(4, 64)
    assert aligned.data_ptr() % 16 == 0 and off.data_ptr() % 16 == 2
    a, b = pfg.aligned16(aligned, off)
    assert a is aligned                          # no copy where none needed
    assert b is not off and b.data_ptr() % 16 == 0 and b.is_contiguous()
    assert torch.equal(b, off)


@pytest.mark.parametrize('m,k,n,dtype,design', [
    (16, 64, 32, torch.bfloat16, 'tensor_core'),
    (5, 53, 29, torch.bfloat16, 'simt'),
    (16, 64, 32, torch.float32, 'simt'),
    (16, 64, 32, torch.float16, 'tensor_core'),
    (5, 53, 29, torch.float16, 'simt')])
@pytest.mark.parametrize('backward', [False, True])
def test_wrapper_routes_each_launch_and_counts_its_design(
        monkeypatch, m, k, n, dtype, design, backward):
    """The launch the wrapper makes, with the kernel's entry point
    stubbed: the design flag, the pointers (an off-16-byte bf16 view is
    copied before a tensor-core launch) and the per-design count."""
    rs = np.random.RandomState(6)
    flat = torch.from_numpy(rs.randn(1 + m * k).astype(np.float32)).to(dtype)
    x = flat[1:].view(m, k)                      # off 16 bytes
    w = torch.from_numpy(rs.randn(k, n).astype(np.float32)).to(dtype)
    dy = torch.from_numpy(rs.randn(m, n).astype(np.float32)).to(dtype)
    kernel = pfg.BWD_KERNEL if backward else pfg.FWD_KERNEL
    seen = []
    monkeypatch.setattr(kernel, '_fn', lambda *a: seen.append(a) or 0)
    monkeypatch.setattr(pfg, 'stream', lambda device: 7)
    before = dict(kernel.variant_launches), kernel.launches
    if backward:
        out = pfg._bwd_cuda(x, w, None, dy, True)
    else:
        out = pfg._fwd_cuda(x, w, None, True)
    args, = seen
    n_ptr = 5 if backward else 4
    assert out.shape == (m, n) and out.dtype == dtype
    assert args[n_ptr:n_ptr + 5] == (m, n, k, 1, pfg._DTYPE_CODE[dtype])
    assert args[n_ptr + 5] == int(design == 'tensor_core')
    assert args[2] is None and args[-1] == 7
    x_ptr = args[0]
    assert (x_ptr != x.data_ptr()) is (design == 'tensor_core')
    if design == 'tensor_core':
        assert x_ptr % 16 == 0
    want = dict(before[0])
    want[design] += 1
    assert kernel.variant_launches == want
    assert kernel.launches == before[1] + 1


def test_launch_counts_by_design_and_their_reset(monkeypatch):
    from paddle_tpu_torch.ops import _build
    kernel = pfg.FWD_KERNEL
    assert tuple(kernel.variant_launches) == pfg.VARIANTS == (
        'tensor_core', 'simt')
    monkeypatch.setattr(kernel, '_fn', lambda *a: 0)
    with pytest.raises(ValueError, match='variant'):
        kernel.launch(0, variant='mma_sync')
    with pytest.raises(ValueError, match='variant'):
        kernel.launch(0)                         # a design must be named
    kernel.launch(0, variant='simt')
    assert kernel.variant_launches['simt'] >= 1
    _build.reset_launches()
    assert kernel.launches == 0 and set(kernel.variant_launches.values()) \
        == {0}
    # LayerNorm names its two designs as well, and a kernel of one design
    # (made here, then taken off the registry) takes no variant
    from paddle_tpu_torch.ops import fused_norm
    assert fused_norm.KERNEL.variant_launches == {'warp': 0, 'block': 0}
    single = _build.Kernel('single_design', source='fused_norm', symbol='x',
                           argtypes=[], replaces='-')
    try:
        monkeypatch.setattr(single, '_fn', lambda *a: 0)
        assert single.variant_launches == {}
        with pytest.raises(ValueError, match='variant'):
            single.launch(variant='simt')
        single.launch()
        assert single.launches == 1
    finally:
        _build.KERNELS.remove(single)


def test_float16_reaches_the_launch_with_code_2(monkeypatch):
    """float16 x and w reach the forward and backward launches with
    dtype code 2 (the entry points stubbed: no card here)."""
    x, w, b = (torch.from_numpy(a) for a in _inputs(16, 64, 32))
    x, w = x.half(), w.half()
    dy = torch.zeros((16, 32), dtype=torch.float16)
    for kernel, run in ((pfg.FWD_KERNEL, lambda: pfg._fwd_cuda(x, w, b,
                                                                False)),
                        (pfg.BWD_KERNEL, lambda: pfg._bwd_cuda(x, w, b, dy,
                                                                False))):
        seen = []
        monkeypatch.setattr(kernel, '_fn', lambda *a: seen.append(a) or 0)
        monkeypatch.setattr(pfg, 'stream', lambda device: 7)
        out = run()
        args, = seen
        assert out.dtype == torch.float16
        assert 2 in args[-4:-1] and args[-4:] == (0, 2, 1, 7)


def test_rows_past_one_grid_are_taken():
    """M above 65535 * 128 rows, which one SIMT grid does not hold: the
    checks take it (the entry point launches it in chunks)."""
    m = 65535 * 128 + 1
    x = torch.zeros((m, 1))
    w = torch.zeros((1, 3))
    assert pfg._checked(x, w, None)[:3] == (m, 3, 1)
