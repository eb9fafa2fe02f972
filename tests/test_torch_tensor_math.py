"""``tensor.creation`` and ``tensor.math`` of the port against the JAX
package on the CPU, forward and gradient (``torch_tensor_oracle``):
the reference's ``tests/test_tensor_ops.py`` cases and every op of the
two modules on seeded numpy inputs, plus the places where a plain torch
call gives other numbers (half-away rounding, tied maxima, the 32-bit
integer rules).  Tolerances: f32 outputs 2e-5, gradients 1e-4 (the
oracle's), exact for integer and bool results.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from torch_tensor_oracle import check, close

RS = np.random.RandomState(0)
A = RS.randn(3, 4).astype(np.float32)
B = (RS.rand(3, 4) + 0.5).astype(np.float32)       # positive
U = (RS.rand(3, 4) * 1.6 - 0.8).astype(np.float32)  # inside (-1, 1)
I = RS.randint(-5, 6, (3, 4)).astype(np.int32)
IP = RS.randint(1, 9, (3, 4)).astype(np.int32)


@pytest.fixture(autouse=True)
def _cpu():
    paddle_tpu_torch.set_device('cpu')
    yield
    paddle_tpu_torch.set_device(None)


BINARY = ['add', 'subtract', 'multiply', 'divide', 'floor_divide', 'mod',
          'remainder', 'floor_mod', 'maximum', 'minimum', 'fmax', 'fmin',
          'atan2', 'pow', 'float_power']


@pytest.mark.parametrize('name', BINARY)
def test_binary_ops(name):
    check(lambda P, x, y: getattr(P, name)(x, y), [B, B[::-1].copy()],
          what=name)


@pytest.mark.parametrize('name', ['add', 'subtract', 'multiply', 'divide',
                                  'pow', 'maximum', 'mod'])
def test_binary_ops_with_a_python_scalar(name):
    check(lambda P, x: getattr(P, name)(x, 2.5), [B], what=name)
    check(lambda P, x: getattr(P, name)(2.5, x), [B], what=name)


@pytest.mark.parametrize('name', ['add', 'multiply', 'floor_divide', 'mod',
                                  'maximum', 'gcd', 'lcm'])
def test_integer_binary_ops(name):
    out = check(lambda P, x, y: getattr(P, name)(x, y), [I, IP], what=name)
    assert out[0].dtype == torch.int32


def test_int_tensor_with_float_scalar_becomes_float32():
    out = check(lambda P, x: P.multiply(x, 0.5), [I])
    assert out[0].dtype == torch.float32
    out = check(lambda P, x: P.add(x, 2), [I])
    assert out[0].dtype == torch.int32


UNARY = {
    'exp': A, 'expm1': A, 'log': B, 'log2': B, 'log10': B, 'log1p': B,
    'sqrt': B, 'rsqrt': B, 'square': A, 'abs': A, 'sign': A, 'sgn': A,
    'sin': A, 'cos': A, 'tan': U, 'asin': U, 'acos': U, 'atan': A,
    'sinh': A, 'cosh': A, 'tanh': A, 'asinh': A, 'acosh': B + 1,
    'atanh': U, 'reciprocal': B, 'floor': A, 'ceil': A, 'round': A,
    'trunc': A, 'erf': A, 'erfinv': U, 'digamma': B, 'lgamma': B,
    'frac': A, 'rad2deg': A, 'deg2rad': A, 'logit': (B - 0.5) * 0.9 + 0.5,
    'stanh': A, 'isfinite': A, 'isinf': A, 'isnan': A, 'angle': A,
    'real': A, 'imag': A, 'conj': A,
}


@pytest.mark.parametrize('name', sorted(UNARY))
def test_unary_ops(name):
    check(lambda P, x: getattr(P, name)(x), [UNARY[name]], what=name)


def test_round_is_half_away_from_zero():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], np.float32)
    out = check(lambda P, v: P.round(v), [x])
    np.testing.assert_array_equal(out[0].detach().numpy(),
                                  [-3, -2, -1, 1, 2, 3])


REDUCE = [
    ('sum', {}), ('sum', {'axis': 1}), ('sum', {'axis': [0, 1],
                                               'keepdim': True}),
    ('prod', {}), ('prod', {'axis': 0}), ('max', {}), ('max', {'axis': 1}),
    ('min', {'axis': 0, 'keepdim': True}), ('amax', {'axis': -1}),
    ('amin', {}), ('logsumexp', {}), ('logsumexp', {'axis': 1}),
    ('mean', {'axis': 0, 'keepdim': True}), ('cumsum', {'axis': 1}),
    ('cumsum', {}), ('cumprod', {'dim': 1}),
]


@pytest.mark.parametrize('name,kw', REDUCE,
                         ids=[f'{n}-{i}' for i, (n, _) in enumerate(REDUCE)])
def test_reductions(name, kw):
    check(lambda P, x: getattr(P, name)(x, **kw), [B], what=name)


def test_max_splits_the_gradient_among_ties():
    x = np.array([[3.0, 1.0, 3.0], [2.0, 2.0, 2.0]], np.float32)
    check(lambda P, v: P.max(v, axis=1), [x])
    check(lambda P, v: P.amin(v), [x])


@pytest.mark.parametrize('name,kw', [('sum', {}), ('sum', {'axis': 0}),
                                     ('cumsum', {'axis': 1}), ('prod', {}),
                                     ('cumprod', {'dim': 0}),
                                     ('count_nonzero', {'axis': 1}),
                                     ('max', {'axis': 1})])
def test_integer_reductions_keep_32_bits(name, kw):
    out = check(lambda P, x: getattr(P, name)(x, **kw), [IP], what=name)
    if name != 'count_nonzero':
        assert out[0].dtype == torch.int32


@pytest.mark.parametrize('name', ['all', 'any'])
def test_logical_reductions(name):
    x = A > 0
    check(lambda P, v: getattr(P, name)(v), [x])
    check(lambda P, v: getattr(P, name)(v, axis=1, keepdim=True), [x])


def test_elementwise_with_arguments():
    check(lambda P, x: P.clip(x, -0.5, 0.5), [A])
    check(lambda P, x: P.clip(x, min=0.1), [A])
    check(lambda P, x: P.logit(x, eps=0.2), [(B - 0.5) * 0.9 + 0.5])
    check(lambda P, x: P.scale(x, 2.0, 0.5), [A])
    check(lambda P, x: P.scale(x, 3.0, 1.0, bias_after_scale=False), [A])
    check(lambda P, x: P.stanh(x, 0.5, 2.0), [A])
    check(lambda P, x: P.diff(x, axis=1), [A])
    check(lambda P, x: P.diff(x, n=2, axis=0), [A])
    check(lambda P, x, y: P.lerp(x, y, 0.3), [A, B])
    check(lambda P, x, y, w: P.lerp(x, y, w), [A, B, U])
    check(lambda P, x, y: P.heaviside(x, y), [A, B])
    nan = np.array([1.0, np.nan, np.inf, -np.inf], np.float32)
    check(lambda P, x: P.nan_to_num(x), [nan], grad=False)
    check(lambda P, x: P.nan_to_num(x, 1.0, 9.0, -9.0), [nan], grad=False)
    check(lambda P, x: [P.isnan(x), P.isinf(x), P.isfinite(x)], [nan])


def test_products():
    v = RS.randn(5).astype(np.float32)
    check(lambda P, i, x, y: P.addmm(i, x, y, 0.5, 2.0),
          [RS.randn(3, 2).astype(np.float32), A,
           RS.randn(4, 2).astype(np.float32)])
    check(lambda P, x, y: P.inner(x, y), [A, B])
    check(lambda P, x, y: P.outer(x, y), [v, v[::-1].copy()])
    check(lambda P, x, y: P.kron(x, y), [A[:2, :2].copy(), B[:2].copy()])
    check(lambda P, x: P.trace(x), [A])
    check(lambda P, x: P.trace(x, offset=1), [A])
    check(lambda P, *xs: P.add_n(list(xs)), [A, B, U])
    idx = np.array([[0, 5], [13, -2]])
    for mode in ('wrap', 'clip'):
        check(lambda P, x: P.take(x, P.to_tensor(idx), mode=mode), [A])
    for P in (paddle_tpu, paddle_tpu_torch):
        with pytest.raises(NotImplementedError):
            P.take(P.to_tensor(A), P.to_tensor(idx))
    check(lambda P, x, y: P.multiplex([x, y], P.to_tensor(
        np.array([[1], [0], [1]], np.int32))), [A, B])
    assert paddle_tpu_torch.broadcast_shape([2, 1, 3], [4, 3]) == \
        paddle_tpu.broadcast_shape([2, 1, 3], [4, 3])


def test_in_place_ops_write_their_argument():
    for name, args in [('add_', (1.0,)), ('subtract_', (0.5,)),
                       ('multiply_', (2.0,)), ('clip_', (-0.2, 0.2)),
                       ('scale_', (2.0, 1.0)), ('tanh_', ()), ('exp_', ()),
                       ('ceil_', ()), ('floor_', ()), ('round_', ()),
                       ('reciprocal_', ()), ('sqrt_', ()), ('rsqrt_', ()),
                       ('increment', (3.0,))]:
        src = B if name in ('sqrt_', 'rsqrt_', 'reciprocal_') else A
        r = paddle_tpu.to_tensor(src.copy())
        p = paddle_tpu_torch.to_tensor(src.copy())
        r2 = getattr(paddle_tpu, name)(r, *args)
        p2 = getattr(paddle_tpu_torch, name)(p, *args)
        assert p2 is p
        close(p.numpy(), np.asarray(r2.numpy()), 2e-5, name)


def test_in_place_ops_keep_the_tape():
    """The reference's ``test_inplace_variants_keep_tape``."""
    x = torch.tensor([1.0, 2.0], requires_grad=True)
    y = x * 2.0
    paddle_tpu_torch.add_(y, 1.0)
    paddle_tpu_torch.subtract_(y, 0.5)
    paddle_tpu_torch.tanh_(y)
    y.sum().backward()
    ref = 2.0 * (1.0 - np.tanh(2 * np.array([1., 2.]) + 0.5) ** 2)
    np.testing.assert_allclose(x.grad.numpy(), ref, rtol=1e-5, atol=1e-7)


def test_complex_parts():
    z = np.array([1. + 2.j, 3. - 1.j], np.complex64)
    for name in ('real', 'imag', 'conj', 'angle', 'abs'):
        check(lambda P, v: getattr(P, name)(v), [z], grad=False, what=name)


# -- creation ----------------------------------------------------------------

def test_creation_matches():
    check(lambda P: [P.zeros([2, 3]), P.ones([2]), P.full([2], 7.0),
                     P.full([2, 2], 3), P.empty([3]), P.eye(3),
                     P.eye(2, 4)], [])
    check(lambda P: [P.arange(5), P.arange(1, 7, 2), P.arange(0.0, 1.0, 0.25),
                     P.linspace(0, 1, 5), P.logspace(0, 2, 3)], [])
    check(lambda P, x: [P.zeros_like(x), P.ones_like(x), P.full_like(x, 2.5),
                        P.empty_like(x)], [A])
    check(lambda P, x: [P.tril(x), P.triu(x, 1), P.tril(x, -1)], [A])
    check(lambda P, x: [P.diag(x), P.diag(x, 1), P.diagflat(x)],
          [A[0].copy()])
    check(lambda P, x: P.diag(x, -1, padding_value=9.0), [A[0].copy()])
    check(lambda P, x: P.diag(x, 1), [A])
    check(lambda P, x, y: P.meshgrid(x, y), [A[0].copy(), B[:, 0].copy()])
    check(lambda P, x: [P.clone(x), P.assign(x)], [A])
    check(lambda P: P.to_tensor([[1.0, 2.0], [3.0, 4.0]]), [])


def test_assign_writes_into_its_output():
    out = paddle_tpu_torch.zeros([3, 4])
    assert paddle_tpu_torch.assign(A, out) is out
    np.testing.assert_array_equal(out.numpy(), A)


def test_create_parameter_shapes_and_defaults():
    p = paddle_tpu_torch.create_parameter([3, 4], 'float32')
    b = paddle_tpu_torch.create_parameter([4], 'float32', is_bias=True)
    assert isinstance(p, paddle_tpu_torch.Parameter) and p.requires_grad
    assert tuple(p.shape) == (3, 4) and float(b.abs().sum()) == 0.0


@pytest.mark.parametrize('name', ['add', 'subtract', 'multiply', 'divide'])
def test_bf16_with_a_python_scalar_rounds_it_as_the_reference(name):
    """The scalar rounds to bf16 before the op, as the reference's weakly
    typed constant does (torch alone would keep 0.1 in f32)."""
    x = np.random.RandomState(4).randn(256).astype(np.float32)
    jx = paddle_tpu.to_tensor(x).astype('bfloat16')
    px = torch.tensor(x).bfloat16()
    want = np.asarray(getattr(paddle_tpu, name)(jx, 0.1).astype(
        'float32').numpy())
    got = getattr(paddle_tpu_torch, name)(px, 0.1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    want = np.asarray(getattr(paddle_tpu, name)(1 / 3, jx).astype(
        'float32').numpy())
    got = getattr(paddle_tpu_torch, name)(1 / 3, px)
    np.testing.assert_array_equal(got.float().numpy(), want)
