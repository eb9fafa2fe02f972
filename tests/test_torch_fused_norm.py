"""The port's fused LayerNorm against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain twin (``_reference`` +
``_ln_bwd``); the JAX side runs the Pallas ``_fwd_kernel`` in TPU
interpret mode, as tests/test_ops_kernels.py does.  The CUDA kernel
itself is held to the same twin on the card
(tests/test_torch_cuda_kernels.py and ``chip_smoke.py``).

Tolerances: forward 2e-5 (f32, the bound tests/test_ops_kernels.py
uses for Pallas vs reference; sums run in another order), gradients
1e-4 (f32 reductions over H and over N in another order).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from paddle_tpu.ops import fused_norm as jax_ln
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import fused_norm as port_ln
from paddle_tpu_torch.nn import functional as PF

FWD_TOL = 2e-5
GRAD_TOL = 1e-4
SHAPES = [(16, 256), (64, 128)]


def _inputs(n, h, seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(n, h) * 2.0 + 0.5).astype(np.float32)
    g = (1.0 + 0.1 * rs.randn(h)).astype(np.float32)
    b = (0.1 * rs.randn(h)).astype(np.float32)
    return x, g, b


@pytest.mark.parametrize('shape', SHAPES)
def test_reference_matches_pallas_kernel(shape):
    n, h = shape
    x, g, b = _inputs(n, h, seed=n + h)
    with pltpu.force_tpu_interpret_mode():
        y, mean, rstd = jax_ln._fwd_pallas(jnp.asarray(x), jnp.asarray(g),
                                           jnp.asarray(b), 1e-5, 8)
    py, pmean, prstd = port_ln._reference(
        torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b), 1e-5)
    for want, got in ((y, py), (mean, pmean), (rstd, prstd)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize('shape', SHAPES)
def test_grads_match_jax(shape):
    n, h = shape
    x, g, b = _inputs(n, h, seed=3 * n + h)
    w = np.random.RandomState(1).randn(n, h).astype(np.float32)

    def jloss(xv, gv, bv):
        return jnp.sum(jax_ln._ln(xv, gv, bv, 1e-5, 8) * w)

    with pltpu.force_tpu_interpret_mode():
        jg = jax.grad(jloss, argnums=(0, 1, 2))(
            jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    tx, tg, tb = (torch.from_numpy(a).requires_grad_() for a in (x, g, b))
    (port_ln.fused_layer_norm(tx, tg, tb, eps=1e-5)
     * torch.from_numpy(w)).sum().backward()
    for want, got in zip(jg, (tx.grad, tg.grad, tb.grad)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


def test_functional_layer_norm_matches_jax_functional():
    """``F.layer_norm`` routes to the fused op in both packages; a 3-D
    input keeps its shape."""
    import paddle_tpu as paddle
    from paddle_tpu.nn import functional as JF
    x, g, b = _inputs(12, 128, seed=5)
    x3 = x.reshape(3, 4, 128)
    want = JF.layer_norm(paddle.to_tensor(x3), 128, paddle.to_tensor(g),
                         paddle.to_tensor(b))
    got = PF.layer_norm(torch.from_numpy(x3), 128, torch.from_numpy(g),
                        torch.from_numpy(b))
    assert tuple(got.shape) == (3, 4, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.value),
                               rtol=FWD_TOL, atol=FWD_TOL)


def test_cpu_wrapper_uses_plain_twin_and_launches_nothing():
    x, g, b = _inputs(8, 128, seed=2)
    before = port_ln.KERNEL.launches
    y = port_ln.fused_layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                                 torch.from_numpy(b))
    ref, _, _ = port_ln._reference(torch.from_numpy(x), torch.from_numpy(g),
                                   torch.from_numpy(b), 1e-5)
    assert torch.equal(y, ref)
    assert port_ln.KERNEL.launches == before


def test_kernel_registered_with_its_tpu_counterpart():
    assert port_ln.KERNEL in _build.KERNELS
    assert port_ln.KERNEL.replaces.startswith('paddle_tpu/ops/fused_norm.py:')
    assert port_ln.KERNEL.source_path == \
        'paddle_tpu_torch/csrc/fused_norm.cu'
    assert 'fused_norm' in _build.sources()


def test_build_without_nvcc_raises(monkeypatch):
    """No nvcc, no kernel: the build raises instead of falling back."""
    monkeypatch.setattr(_build.shutil, 'which', lambda name: None)
    monkeypatch.setenv('CUDA_HOME', '/nonexistent-cuda')
    monkeypatch.setattr(_build, 'BUILD_DIR', '/nonexistent-build-dir')
    with pytest.raises(RuntimeError, match='nvcc'):
        _build.build(['fused_norm'])


# widths past the warp design (2560: the block design) and off the
# vector loads (770: H % 4 != 0, rows off 16 bytes)
WIDE_SHAPES = [(6, 2560), (10, 770)]


@pytest.mark.parametrize('shape', WIDE_SHAPES)
def test_any_width_matches_the_reference(shape):
    """The reference computes any H (its Pallas gate sends these to its
    plain path); the port's twin matches it, forward and gradients."""
    n, h = shape
    x, g, b = _inputs(n, h, seed=h)
    w = np.random.RandomState(2).randn(n, h).astype(np.float32)
    want = jax_ln.fused_layer_norm(jnp.asarray(x), jnp.asarray(g),
                                   jnp.asarray(b), 1e-5)
    jg = jax.grad(lambda xv, gv, bv: jnp.sum(
        jax_ln.fused_layer_norm(xv, gv, bv, 1e-5) * w), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    tx, tg, tb = (torch.from_numpy(a).requires_grad_() for a in (x, g, b))
    got = port_ln.fused_layer_norm(tx, tg, tb, eps=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=FWD_TOL, atol=FWD_TOL)
    (got * torch.from_numpy(w)).sum().backward()
    for want_g, got_g in zip(jg, (tx.grad, tg.grad, tb.grad)):
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


def _stub_launch(monkeypatch):
    """The kernel's entry point replaced by a recorder (no card here):
    what the wrapper hands a launch on a CUDA tensor.  The launch counts
    go back to theirs after the test, so a later file in the same
    process sees the CPU's zero launches."""
    seen = []
    monkeypatch.setattr(port_ln.KERNEL, '_fn',
                        lambda *a: seen.append(a) or 0)
    monkeypatch.setattr(port_ln.KERNEL, 'launches', port_ln.KERNEL.launches)
    monkeypatch.setattr(port_ln.KERNEL, 'variant_launches',
                        dict(port_ln.KERNEL.variant_launches))
    monkeypatch.setattr(port_ln, 'stream', lambda device: 7)
    return seen


@pytest.mark.parametrize('h', [2560, 770, 4099])
@pytest.mark.parametrize('dtype,code', [(torch.float32, 0),
                                        (torch.bfloat16, 1),
                                        (torch.float16, 2)])
def test_any_width_and_float16_reach_the_kernel_launch(monkeypatch, h,
                                                        dtype, code):
    """Every width and float16 reach the launch, with the dtype's code;
    a view off 16 bytes is passed as it is (the kernel then takes its
    scalar loads)."""
    seen = _stub_launch(monkeypatch)
    flat = torch.zeros(1 + 3 * h, dtype=dtype)
    x = flat[1:].view(3, h)
    g, b = torch.ones(h), torch.zeros(h)
    before = port_ln.KERNEL.launches
    y, mean, rstd = port_ln._fwd_cuda(x, g, b, 1e-5)
    args, = seen
    assert args[0] == x.data_ptr() and args[6:8] == (3, h)
    assert args[9] == code and args[11] == 7
    assert args[10] == (h > 2048)           # the design: 0 warp, 1 block
    assert y.dtype == dtype and y.shape == (3, h)
    assert mean.shape == rstd.shape == (3,)
    assert port_ln.KERNEL.launches == before + 1
    with pytest.raises(TypeError, match='float16'):
        port_ln._fwd_cuda(x.double(), g, b, 1e-5)


def test_without_affine_the_port_keeps_f32_two_pass_statistics():
    """A documented difference.  Without weight and bias the reference's
    ``layer_norm`` takes its plain path, which for bf16 computes in x's
    dtype with a one-pass variance (the square in bf16); the port's
    kernel, and its twin, keep f32 two-pass statistics for every call.
    On rows whose mean is large against their spread the reference's
    variance is off by far more than bf16's rounding of y, the port's
    is not."""
    import paddle_tpu as paddle
    from paddle_tpu.nn import functional as JF
    rs = np.random.RandomState(4)
    x = (8.0 + 0.5 * rs.randn(16, 256)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    xf = xb.float().numpy()                       # the bf16 values, exact
    exact = (xf - xf.mean(-1, keepdims=True)) / np.sqrt(
        xf.var(-1, keepdims=True) + 1e-5)
    got = PF.layer_norm(xb, 256).float().numpy()
    ref = port_ln._reference(xb.reshape(16, 256), None, None, 1e-5)[0]
    assert np.array_equal(got, ref.float().numpy())
    port_err = np.abs(got - exact).max()
    jx = paddle.to_tensor(np.asarray(jnp.asarray(x).astype(jnp.bfloat16)))
    want = np.asarray(JF.layer_norm(jx, 256).value.astype(jnp.float32))
    jax_err = np.abs(want - exact).max()
    assert port_err <= 2e-2 * (1 + np.abs(exact).max())
    assert jax_err > 10 * port_err, (jax_err, port_err)


# (n, h, dtype, offset in elements of x's view, design): 'warp' up to H
# 2048 and 'block' above, whatever the alignment (which only picks the
# load width inside the design)
_DESIGN_CASES = [(64, 768, torch.float32, 0, 'warp'),
                 (3, 768, torch.float32, 1, 'warp'),
                 (3, 770, torch.float32, 0, 'warp'),
                 (3, 1, torch.float16, 0, 'warp'),
                 (3, 2048, torch.bfloat16, 0, 'warp'),
                 (3, 2049, torch.float32, 0, 'block'),
                 (3, 2560, torch.bfloat16, 1, 'block'),
                 (2, 8193, torch.float32, 0, 'block'),
                 (2, 40000, torch.float16, 0, 'block')]


@pytest.mark.parametrize('n,h,dtype,offset,design', _DESIGN_CASES)
def test_wrapper_names_the_design_for_the_width(monkeypatch, n, h, dtype,
                                                offset, design):
    """The wrapper names the design before the launch and passes its code
    (the entry point stubbed: no card here)."""
    seen = []
    monkeypatch.setattr(port_ln.KERNEL, 'launch',
                        lambda *a, variant=None: seen.append((a, variant)))
    monkeypatch.setattr(port_ln, 'stream', lambda device: 7)
    flat = torch.zeros(offset + n * h, dtype=dtype)
    x = flat[offset:].view(n, h)
    y, mean, rstd = port_ln._fwd_cuda(x, torch.ones(h), None, 1e-5)
    (args, variant), = seen
    assert variant == design
    assert args[10] == port_ln.VARIANTS.index(design)
    assert args[2] is None                  # no beta: a null pointer
    assert y.shape == (n, h) and mean.shape == rstd.shape == (n,)


def test_gamma_of_another_dtype_is_cast_and_kept_through_the_launch(
        monkeypatch):
    """A bf16 gamma reaches the kernel as an f32 copy whose memory stays
    alive through the launch (not handed back for y or the statistics)."""
    seen = []

    def launch(*args, variant=None):
        seen.append(args)
        gamma_ptr, y_ptr = args[1], args[3]
        assert gamma_ptr != y_ptr

    monkeypatch.setattr(port_ln.KERNEL, 'launch', launch)
    monkeypatch.setattr(port_ln, 'stream', lambda device: 7)
    x = torch.zeros(4, 128)
    port_ln._fwd_cuda(x, torch.ones(128, dtype=torch.bfloat16), None, 1e-5)
    assert len(seen) == 1

