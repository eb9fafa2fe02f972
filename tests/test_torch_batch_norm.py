"""The port's BatchNorm against the JAX package's, on the CPU.

The same seeded numpy inputs (a nonzero mean, so the one-pass variance
is exercised) go through ``paddle_tpu.nn.functional.batch_norm`` under
``jax.value_and_grad`` and through the port's.  Gradients are taken
with the running statistics left out (the reference writes them by
``set_value``, which a trace must not reach); the running statistics
are compared after eager calls.

Tolerances: f32 forward 2e-5 and gradients 1e-4 (sums in another order
than XLA's); f32 running statistics 1e-5.  bf16 and f16: forward 2e-2
relative to the output's scale (both round the f32 scale/shift and the
result to the 16-bit type), gradients 3e-2 of the largest (the backward
runs in the 16-bit type, with XLA and PyTorch rounding partial sums at
other places), running statistics 1e-2 (under O2 the reference's update
itself runs in bf16, whose step is 2^-8).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.autograd import no_grad as jax_no_grad
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import amp, nn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import norm as norm_mod

C = 6
TOL = {'float32': (2e-5, 1e-4, 1e-5), 'bfloat16': (2e-2, 3e-2, 1e-2),
       'float16': (2e-2, 3e-2, 1e-2)}
JAX_DT = {'float32': jnp.float32, 'bfloat16': jnp.bfloat16,
          'float16': jnp.float16}
TORCH_DT = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
            'float16': torch.float16}
# data_format -> input shape
SHAPES = {'NCHW': (4, C, 5, 3), 'NHWC': (4, 5, 3, C), 'NCL': (8, C, 7),
          'NLC': (8, 7, C), 'NCDHW': (2, C, 3, 4, 2)}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _close(got, want, tol, what=''):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _auto_cast(level, package=amp):
    """``package.auto_cast(level)``, or nothing without a level."""
    return package.auto_cast(level=level) if level else \
        contextlib.nullcontext()


def _inputs(data_format, seed=0):
    rs = np.random.RandomState(seed)
    x = (1.5 * rs.randn(*SHAPES[data_format]) + 0.7).astype(np.float32)
    w = (1.0 + 0.2 * rs.randn(C)).astype(np.float32)
    b = (0.1 * rs.randn(C)).astype(np.float32)
    return x, w, b


def _jax_bn_grads(x, w, b, dtype, data_format, level=None, **kw):
    """(output, [dx, dw, db]) of sum(batch_norm(x) * cot) by jax.grad,
    the running statistics left out."""
    xj = jnp.asarray(x).astype(JAX_DT[dtype])

    def fwd(v, wv, bv):
        with jax_no_grad(), _auto_cast(level, paddle.amp):
            out = JF.batch_norm(
                JaxTensor._from_value(v), None, None,
                JaxTensor._from_value(wv), JaxTensor._from_value(bv),
                training=True, data_format=data_format, **kw)
        return out.value

    out = fwd(xj, jnp.asarray(w), jnp.asarray(b))
    cot = np.random.RandomState(9).randn(*out.shape).astype(np.float32)

    def loss(*a):
        return jnp.sum(fwd(*a).astype(jnp.float32) * cot)

    grads = jax.grad(loss, argnums=(0, 1, 2))(xj, jnp.asarray(w),
                                              jnp.asarray(b))
    return _np(out), [_np(g) for g in grads], cot


def _torch_bn_grads(x, w, b, dtype, data_format, cot, level=None, **kw):
    xt = torch.from_numpy(x).to(TORCH_DT[dtype]).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    with _auto_cast(level):
        out = F.batch_norm(xt, None, None, wt, bt, training=True,
                           data_format=data_format, **kw)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    return out, [_np(t.grad) for t in (xt, wt, bt)]


def _jax_running(x, dtype, data_format, level=None, steps=1, **kw):
    """The reference's running statistics after ``steps`` calls on
    seeded batches (eager, ``set_value``)."""
    rm = paddle.to_tensor(np.zeros(C, np.float32))
    rv = paddle.to_tensor(np.ones(C, np.float32))
    for i in range(steps):
        xi = x if i == 0 else _inputs(data_format, seed=i)[0]
        xj = JaxTensor._from_value(jnp.asarray(xi).astype(JAX_DT[dtype]))
        with _auto_cast(level, paddle.amp):
            JF.batch_norm(xj, rm, rv, training=True, data_format=data_format,
                          **kw)
    return _np(rm.value), _np(rv.value)


def _torch_running(x, dtype, data_format, level=None, steps=1, **kw):
    rm, rv = torch.zeros(C), torch.ones(C)
    for i in range(steps):
        xi = x if i == 0 else _inputs(data_format, seed=i)[0]
        xt = torch.from_numpy(xi).to(TORCH_DT[dtype])
        with _auto_cast(level):
            F.batch_norm(xt, rm, rv, training=True, data_format=data_format,
                         **kw)
    assert rm.dtype == rv.dtype == torch.float32
    return _np(rm), _np(rv)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16', 'float16'])
@pytest.mark.parametrize('data_format', list(SHAPES))
def test_train_forward_gradients_and_running_stats_match_jax(dtype,
                                                             data_format):
    x, w, b = _inputs(data_format)
    fwd_tol, grad_tol, run_tol = TOL[dtype]
    want, want_g, cot = _jax_bn_grads(x, w, b, dtype, data_format)
    out, got_g = _torch_bn_grads(x, w, b, dtype, data_format, cot)
    assert out.dtype == TORCH_DT[dtype]
    _close(_np(out), want, fwd_tol, 'out')
    for name, g, wg in zip(('dx', 'dw', 'db'), got_g, want_g):
        _close(g, wg, grad_tol, name)
    for g, wg in zip(_torch_running(x, dtype, data_format),
                     _jax_running(x, dtype, data_format)):
        _close(g, wg, run_tol, 'running')


@pytest.mark.parametrize('dtype,level', [('float32', None),
                                         ('bfloat16', 'O2'),
                                         ('float32', 'O2')])
def test_running_stats_after_three_steps(dtype, level):
    """Three batches: under O2 the reference's update runs in bf16
    (``multiply``/``add`` are not on the keep list), and so does the
    port's."""
    x = _inputs('NHWC')[0]
    run_tol = TOL['bfloat16' if level else dtype][2]
    got = _torch_running(x, dtype, 'NHWC', level=level, steps=3)
    want = _jax_running(x, dtype, 'NHWC', level=level, steps=3)
    for g, wv in zip(got, want):
        _close(g, wv, run_tol)
    if level:   # the values sit on the bf16 grid, as the reference's
        for g in got:
            np.testing.assert_array_equal(
                g, _np(torch.from_numpy(g).to(torch.bfloat16)))


def test_under_o2_the_inputs_come_as_they_are():
    """``batch_norm`` is on the keep list: a bf16 x with f32 weights
    under O2, as in the reference; the output is bf16."""
    x, w, b = _inputs('NHWC')
    want, want_g, cot = _jax_bn_grads(x, w, b, 'bfloat16', 'NHWC',
                                      level='O2')
    out, got_g = _torch_bn_grads(x, w, b, 'bfloat16', 'NHWC', cot,
                                 level='O2')
    assert out.dtype == torch.bfloat16
    _close(_np(out), want, TOL['bfloat16'][0])
    for g, wg in zip(got_g, want_g):
        _close(g, wg, TOL['bfloat16'][1])


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('mode', ['eval', 'use_global_stats'])
def test_running_statistics_normalise_in_eval_and_global_stats(dtype, mode):
    x, w, b = _inputs('NCHW')
    rs = np.random.RandomState(4)
    rm = (0.5 * rs.randn(C)).astype(np.float32)
    rv = (0.5 + rs.rand(C)).astype(np.float32)
    training = mode == 'use_global_stats'
    kw = dict(training=training, data_format='NCHW',
              use_global_stats=True if training else None)
    want = JF.batch_norm(
        JaxTensor._from_value(jnp.asarray(x).astype(JAX_DT[dtype])),
        paddle.to_tensor(rm), paddle.to_tensor(rv), paddle.to_tensor(w),
        paddle.to_tensor(b), **kw)
    rmt, rvt = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    got = F.batch_norm(torch.from_numpy(x).to(TORCH_DT[dtype]), rmt, rvt,
                       torch.from_numpy(w), torch.from_numpy(b), **kw)
    assert got.dtype == TORCH_DT[dtype]
    _close(_np(got), _np(want.value), TOL[dtype][0])
    assert np.array_equal(rmt.numpy(), rm) and np.array_equal(rvt.numpy(),
                                                              rv)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_nhwc_is_nchw(dtype):
    x, w, b = _inputs('NCHW')
    xt = torch.from_numpy(x).to(TORCH_DT[dtype])
    rm1, rv1, rm2, rv2 = (torch.zeros(C), torch.ones(C), torch.zeros(C),
                          torch.ones(C))
    nchw = F.batch_norm(xt, rm1, rv1, torch.from_numpy(w),
                        torch.from_numpy(b), training=True)
    nhwc = F.batch_norm(xt.permute(0, 2, 3, 1).contiguous(), rm2, rv2,
                        torch.from_numpy(w), torch.from_numpy(b),
                        training=True, data_format='NHWC')
    tol = 1e-6 if dtype == 'float32' else 1e-2
    torch.testing.assert_close(nhwc.permute(0, 3, 1, 2).float(),
                               nchw.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(rm1, rm2, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(rv1, rv2, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('dtype', ['bfloat16', 'float16'])
def test_scalars_round_as_the_reference_weak_types_do(dtype):
    for value in (0.9, 1.0 - 0.9, 60 / 59, 512 / 511, 8 / 7, 1e-5):
        want = float(jnp.ones((), JAX_DT[dtype]) * value)
        assert norm_mod._scalar(value, TORCH_DT[dtype]) == want, value
    assert norm_mod._scalar(0.1, torch.float32) == 0.1


def test_layers_buffers_and_state_keys():
    layer = nn.BatchNorm2D(C, data_format='NHWC', device='cpu')
    assert layer._mean.dtype == layer._variance.dtype == torch.float32
    assert torch.equal(layer._mean, torch.zeros(C))
    assert torch.equal(layer._variance, torch.ones(C))
    jl = paddle.nn.BatchNorm2D(C, data_format='NHWC')
    assert set(layer.state_dict()) == set(jl.state_dict()) == {
        'weight', 'bias', '_mean', '_variance'}
    assert nn.BatchNorm1D(C, device='cpu').data_format == 'NCL'
    assert nn.BatchNorm3D(C, device='cpu').data_format == 'NCDHW'
    with pytest.raises(NotImplementedError):
        nn.SyncBatchNorm(C)
    seq = nn.Sequential(nn.Conv2D(3, C, 1, device='cpu'),
                        nn.BatchNorm2D(C, device='cpu'))
    assert list(seq.state_dict()) == ['0.weight', '0.bias', '1.weight',
                                      '1.bias', '1._mean', '1._variance']


def test_layer_trains_and_evaluates_like_the_jax_layer():
    """The layer over three batches in train mode (buffers written in
    place: the same tensor objects), then one in eval mode."""
    layer = nn.BatchNorm2D(C, data_format='NHWC', device='cpu')
    jl = paddle.nn.BatchNorm2D(C, data_format='NHWC')
    mean_obj = layer._mean
    for i in range(3):
        x = _inputs('NHWC', seed=i)[0]
        got = layer(torch.from_numpy(x))
        want = jl(paddle.to_tensor(x))
        _close(_np(got), _np(want.value), TOL['float32'][0])
    assert layer._mean is mean_obj
    _close(_np(layer._mean), _np(jl._mean.value), TOL['float32'][2])
    _close(_np(layer._variance), _np(jl._variance.value), TOL['float32'][2])
    layer.eval()
    jl.eval()
    x = _inputs('NHWC', seed=5)[0]
    _close(_np(layer(torch.from_numpy(x))),
           _np(jl(paddle.to_tensor(x)).value), TOL['float32'][0])
