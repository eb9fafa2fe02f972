"""The port's group, instance, local-response and multi-axis layer
normalisation, and ``SpectralNorm``, against the JAX package's, on the
CPU.

The same seeded numpy inputs go through both packages
(``torch_tensor_oracle.check``: f32 outputs within 2e-5, every input's
gradient within 1e-4; bf16 2e-2).  The reference's dtype rules are held
exactly: ``group_norm`` of a bf16 ``x`` with f32 weight and bias comes
back f32 (the normalised bf16 tensor meets the f32 weight), while
``instance_norm`` folds weight and bias into x's dtype and comes back
bf16; both take the one-pass variance for a 16-bit input.
``local_response_norm`` divides by ``(k + alpha * sum x^2)^beta`` with
``alpha`` not divided by ``size`` (PyTorch's own divides it: the test
shows the two apart).  ``SpectralNorm``'s power iteration starts from
another draw than the reference's (``jax.random`` bits cannot be drawn
in PyTorch), so the layer is held to the reference once the iteration
has converged (50 rounds), and its own first round to a replay of the
formula from its ``u``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer import norm as norm_mod
from torch_seq_oracle import compare_vjp, load_from_jax
from torch_tensor_oracle import check

BF16_TOL = 2e-2


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device('cpu')
    yield
    paddle.set_device(None)


def _x(*shape, seed=0, scale=1.0, shift=0.0):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape) * scale + shift).astype(np.float32)


@pytest.mark.parametrize('df,groups,affine', [
    ('NCHW', 4, True), ('NHWC', 2, True), ('NCHW', 8, False),
    ('NCL', 4, True), ('NCDHW', 2, True)])
def test_group_norm_matches_jax(df, groups, affine):
    nd = {'NCL': 3, 'NCDHW': 5}.get(df, 4)
    shape = (2, 5, 6, 8) if df == 'NHWC' else (2, 8) + (5,) * (nd - 2)
    x = _x(*shape, shift=0.5)
    w, b = _x(8, seed=1), _x(8, seed=2)
    if affine:
        check(lambda P, x, w, b: P.nn.functional.group_norm(
            x, groups, 1e-5, w, b, df), [x, w, b])
    else:
        check(lambda P, x: P.nn.functional.group_norm(
            x, groups, 1e-5, data_format=df), [x])


def test_group_norm_bf16_with_f32_weight_is_f32_as_in_the_reference():
    """A bf16 ``x`` (the one-pass variance) with f32 weight and bias:
    the reference's output is f32, and so is the port's."""
    x, w, b = _x(2, 8, 6, 6, shift=2.0), _x(8, seed=1), _x(8, seed=2)
    out = check(lambda P, x, w, b: P.nn.functional.group_norm(
        P.cast(x, 'bfloat16'), 4, 1e-5, w, b), [x, w, b], tol=BF16_TOL,
        grad_tol=BF16_TOL)[0]
    assert out.dtype == torch.float32
    ref = jpaddle.nn.functional.group_norm(
        jpaddle.cast(jpaddle.to_tensor(x), 'bfloat16'), 4, 1e-5,
        jpaddle.to_tensor(w), jpaddle.to_tensor(b))
    assert str(ref.dtype).endswith('float32')


@pytest.mark.parametrize('df,affine', [('NCHW', True), ('NHWC', True),
                                       ('NCL', False), ('NCDHW', True)])
def test_instance_norm_matches_jax(df, affine):
    nd = {'NCL': 3, 'NCDHW': 5}.get(df, 4)
    shape = (2, 5, 7, 3) if df == 'NHWC' else (2, 3) + (5,) * (nd - 2)
    x = _x(*shape, shift=-1.0)
    w, b = _x(3, seed=1), _x(3, seed=2)
    if affine:
        check(lambda P, x, w, b: P.nn.functional.instance_norm(
            x, weight=w, bias=b, eps=1e-5, data_format=df), [x, w, b])
    else:
        check(lambda P, x: P.nn.functional.instance_norm(
            x, data_format=df), [x])


def test_instance_norm_bf16_stays_bf16_as_in_the_reference():
    x, w, b = _x(2, 3, 6, 6, shift=2.0), _x(3, seed=1), _x(3, seed=2)
    got = F.instance_norm(torch.from_numpy(x).bfloat16(),
                          weight=torch.from_numpy(w),
                          bias=torch.from_numpy(b))
    want = jpaddle.nn.functional.instance_norm(
        jpaddle.cast(jpaddle.to_tensor(x), 'bfloat16'),
        weight=jpaddle.to_tensor(w), bias=jpaddle.to_tensor(b))
    assert got.dtype == torch.bfloat16
    assert str(want.dtype).endswith('bfloat16')
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype('float32').numpy()),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize('size,df', [(5, 'NCHW'), (4, 'NHWC'), (3, 'NCL')])
def test_local_response_norm_matches_jax(size, df):
    shape = {'NCHW': (2, 7, 4, 4), 'NHWC': (2, 4, 4, 7),
             'NCL': (2, 7, 5)}[df]
    x = _x(*shape, scale=3.0)
    check(lambda P, x: P.nn.functional.local_response_norm(
        x, size, alpha=1e-2, beta=0.75, k=2.0, data_format=df), [x])


def test_local_response_norm_alpha_is_not_divided_by_size():
    """The reference's (and the port's) ``alpha`` multiplies the sum of
    squares as it is; ``torch.nn.functional.local_response_norm``
    divides it by ``size`` first, which is the port's at
    ``alpha / size``."""
    x = torch.from_numpy(_x(2, 7, 4, 4, scale=3.0))
    ours = F.local_response_norm(x, 5, alpha=1e-2, beta=0.75, k=2.0)
    theirs = torch.nn.functional.local_response_norm(x, 5, alpha=1e-2,
                                                     beta=0.75, k=2.0)
    assert float((ours - theirs).abs().max()) > 1e-2
    torch.testing.assert_close(
        F.local_response_norm(x, 5, alpha=1e-2 / 5, beta=0.75, k=2.0),
        theirs, rtol=1e-5, atol=1e-6)


def test_local_response_norm_bf16_matches_jax():
    x = _x(2, 7, 4, 4, scale=3.0)
    check(lambda P, x: P.cast(P.nn.functional.local_response_norm(
        P.cast(x, 'bfloat16'), 5, alpha=1e-2, k=2.0), 'float32'), [x],
        tol=BF16_TOL, grad_tol=BF16_TOL)


@pytest.mark.parametrize('affine', [True, False])
def test_layer_norm_over_two_axes_matches_jax(affine):
    x, w, b = _x(3, 4, 5, 6, shift=1.0), _x(5, 6, seed=1), _x(5, 6, seed=2)
    if affine:
        check(lambda P, x, w, b: P.nn.functional.layer_norm(
            x, [5, 6], w, b, 1e-5), [x, w, b])
    else:
        check(lambda P, x: P.nn.functional.layer_norm(x, [4, 5, 6]), [x])


def test_layer_norm_over_two_axes_bf16_matches_jax():
    """The plain path rounds ``1 / sqrt(var + eps)`` to x's dtype and
    applies weight and bias in it, as the reference does."""
    x, w, b = _x(3, 4, 5, 6, shift=1.0), _x(5, 6, seed=1), _x(5, 6, seed=2)
    out = check(lambda P, x, w, b: P.cast(P.nn.functional.layer_norm(
        P.cast(x, 'bfloat16'), [5, 6], w, b), 'float32'), [x, w, b],
        tol=BF16_TOL, grad_tol=BF16_TOL)[0]
    assert out.dtype == torch.float32
    assert F.layer_norm(torch.from_numpy(x).bfloat16(), [5, 6],
                        torch.from_numpy(w), torch.from_numpy(b)).dtype \
        == torch.bfloat16


@pytest.mark.parametrize('name,shape', [
    ('GroupNorm', (2, 8, 5, 5)), ('InstanceNorm1D', (2, 8, 9)),
    ('InstanceNorm2D', (2, 8, 5, 5)), ('InstanceNorm3D', (2, 8, 3, 4, 3)),
    ('LocalResponseNorm', (2, 8, 5, 5))])
def test_norm_layers_match_jax(name, shape):
    args = {'GroupNorm': (4, 8), 'LocalResponseNorm': (3,)}.get(name, (8,))
    jpaddle.seed(0)
    jm = getattr(jpaddle.nn, name)(*args)
    pm = getattr(nn, name)(*args)
    assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} == {
        k: tuple(v.shape) for k, v in jm.state_dict().items()}
    load_from_jax(pm, jm)
    with torch.no_grad():
        for p in pm.parameters():
            p.add_(torch.from_numpy(_x(*p.shape, seed=3)))
    jm.set_state_dict({k: v.detach().numpy()
                       for k, v in pm.state_dict().items()})
    compare_vjp(jm, pm, lambda m, v: m(v), [_x(*shape, shift=0.3)], 2e-5,
                1e-4)


def test_instance_norm_layer_attr_false_drops_both_as_in_the_reference():
    pm = nn.InstanceNorm2D(4, bias_attr=False)
    jm = jpaddle.nn.InstanceNorm2D(4, bias_attr=False)
    assert pm.weight is None and pm.bias is None
    assert jm.weight is None and jm.bias is None
    assert dict(pm.state_dict()) == {}


def test_spectral_norm_layer_agrees_with_the_reference_once_converged():
    """``SpectralNorm`` at 50 power iterations: sigma converged from
    either start, so output and gradient agree; at one iteration the
    output is the formula replayed from the port's fixed start (a draw
    of a generator seeded 0), the same at every call."""
    w = _x(6, 3, 2, 2, seed=4)
    w[0] *= 3.0                     # a well separated top singular value
    check(lambda P, w: P.nn.SpectralNorm([6, 3, 2, 2], dim=0,
                                         power_iters=50)(w), [w],
          tol=1e-5, grad_tol=1e-4)
    check(lambda P, w: P.nn.SpectralNorm([6, 3, 2, 2], dim=1,
                                         power_iters=50)(w), [w],
          tol=1e-5, grad_tol=1e-4)
    tw = torch.from_numpy(w).double()
    mat = tw.reshape(6, -1)
    u = torch.randn(6, generator=torch.Generator().manual_seed(0)).double()
    v = mat.T @ u
    v = v / (v.norm() + 1e-12)
    u = mat @ v
    u = u / (u.norm() + 1e-12)
    want = tw / (u @ (mat @ v))
    layer = nn.SpectralNorm([6, 3, 2, 2])
    got = layer(torch.from_numpy(w))
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-6)
    assert torch.equal(layer(torch.from_numpy(w)), got)
    assert norm_mod._start_u.cache_info().currsize >= 1
