"""The port's convolution and pooling against the JAX package's, on the
CPU.

The same seeded numpy inputs go through the JAX functional (under
``jax.value_and_grad``) and the port's; the cotangent is a seeded
random tensor of the output's shape.  Tolerances: f32 forward 2e-5 and
gradients 1e-4 (sums in another order than XLA's); bf16 2e-2 relative
to the output's scale (both round the f32 result to bf16; XLA and
PyTorch round intermediate sums at other places).  Max pooling selects,
so its outputs and gradients are held exactly, a bf16 tie inside a
window included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.autograd import no_grad as jax_no_grad
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn import initializer as jax_init
from paddle_tpu_torch import amp, nn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer
from paddle_tpu_torch.nn.functional import conv as conv_mod

TOL, GRAD_TOL, BF16_TOL = 2e-5, 1e-4, 2e-2


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _jax_vjp(fn, args, cot):
    """(output, gradients) of ``sum(fn(*args) * cot)`` by jax.grad."""
    def f(*vals):
        with jax_no_grad():
            out = fn(*[JaxTensor._from_value(v) for v in vals]).value
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, out), grads = jax.value_and_grad(
        f, argnums=tuple(range(len(args))), has_aux=True)(*args)
    return _np(out), [_np(g) for g in grads]


def _torch_vjp(fn, args, cot):
    ts = [a.clone().requires_grad_(True) for a in args]
    out = fn(*ts)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    return _np(out), [_np(t.grad) for t in ts]


def _compare(jfn, tfn, arrays, dtype=np.float32, tol=TOL, grad_tol=GRAD_TOL,
             seed=3):
    """``arrays`` (f32 numpy) in ``dtype`` through both; forward and
    every gradient compared."""
    jd = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
    td = torch.bfloat16 if dtype == 'bfloat16' else torch.float32
    targs = [torch.from_numpy(a).to(td) for a in arrays]
    with torch.no_grad():
        shape = tfn(*targs).shape
    cot = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    got, got_g = _torch_vjp(tfn, targs, cot)
    want, want_g = _jax_vjp(jfn, [jnp.asarray(a).astype(jd) for a in arrays],
                            cot)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        gs = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=grad_tol, atol=grad_tol * gs,
                                   err_msg=f'gradient {i}')
    return got, got_g


def _rand(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


# (n, data_format, padding, stride, dilation, groups, bias)
CONV_CASES = [
    (2, 'NCHW', 0, 1, 1, 1, True),
    (2, 'NCHW', 1, 2, 1, 1, False),
    (2, 'NHWC', [1, 2], 1, 2, 1, True),
    (2, 'NHWC', [1, 2, 0, 1], 2, 1, 2, False),
    (2, 'NHWC', [(2, 1), (2, 1)], 1, 1, 1, False),
    (2, 'NCHW', 'SAME', 2, 1, 2, True),
    (2, 'NHWC', 'same', 3, 2, 1, True),
    (2, 'NCHW', 'VALID', 1, 1, 4, True),
    (1, 'NCL', 2, 1, 1, 1, True),
    (1, 'NLC', 'SAME', 2, 1, 2, True),
    (1, 'NLC', [(0, 3)], 1, 2, 1, False),
    (3, 'NCDHW', 1, 1, 1, 1, True),
    (3, 'NDHWC', 'SAME', 2, 1, 2, False),
]


def _conv_case(n, data_format, groups, rs):
    cin, cout, k, size = 4, 8, 3, 9
    sp = (size,) * n
    x = _rand(rs, 2, *sp, cin) if data_format[-1] == 'C' else \
        _rand(rs, 2, cin, *sp)
    w = _rand(rs, cout, cin // groups, *(k,) * n) * 0.3
    return x, w, _rand(rs, cout)


@pytest.mark.parametrize('case', CONV_CASES, ids=lambda c: '-'.join(
    str(v).replace(' ', '') for v in c))
def test_conv_matches_jax(case):
    n, df, padding, stride, dilation, groups, bias = case
    x, w, b = _conv_case(n, df, groups, np.random.RandomState(n + groups))
    jconv = {1: JF.conv1d, 2: JF.conv2d, 3: JF.conv3d}[n]
    tconv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[n]
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups, data_format=df)
    if bias:
        _compare(lambda v, k, c: jconv(v, k, c, **kw),
                 lambda v, k, c: tconv(v, k, c, **kw), [x, w, b])
    else:
        _compare(lambda v, k: jconv(v, k, **kw),
                 lambda v, k: tconv(v, k, **kw), [x, w])


@pytest.mark.parametrize('df', ['NCHW', 'NHWC'])
def test_conv2d_bf16_and_under_o2(df):
    """bf16 inputs, and f32 inputs under O2 (conv2d is white-listed:
    cast to bf16)."""
    x, w, b = _conv_case(2, df, 1, np.random.RandomState(5))
    kw = dict(stride=2, padding=1, data_format=df)
    got, _ = _compare(lambda v, k, c: JF.conv2d(v, k, c, **kw),
                      lambda v, k, c: F.conv2d(v, k, c, **kw), [x, w, b],
                      dtype='bfloat16', tol=BF16_TOL, grad_tol=BF16_TOL)
    with amp.auto_cast(level='O2'):
        out = F.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b), **kw)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(out), got)


def test_nhwc_conv_is_the_nchw_conv():
    rs = np.random.RandomState(0)
    x, w, b = _rand(rs, 2, 4, 9, 9), _rand(rs, 8, 4, 3, 3), _rand(rs, 8)
    tx = torch.from_numpy(x)
    nchw = F.conv2d(tx, torch.from_numpy(w), torch.from_numpy(b), 2, 1)
    nhwc = F.conv2d(tx.permute(0, 2, 3, 1).contiguous(), torch.from_numpy(w),
                    torch.from_numpy(b), 2, 1, data_format='NHWC')
    torch.testing.assert_close(nhwc.permute(0, 3, 1, 2), nchw, rtol=1e-6,
                               atol=1e-6)


def test_conv2d_layer_init_law_and_state():
    """KaimingUniform(fan_in) weights (limit sqrt(2) sqrt(3 / fan_in))
    and Uniform(+-1/sqrt(fan_in)) bias, OIHW whatever the layout, drawn
    from the seed; ``bias_attr=False`` leaves no bias."""
    layer = nn.Conv2D(16, 64, 3, groups=2, data_format='NHWC', device='cpu')
    assert tuple(layer.weight.shape) == (64, 8, 3, 3)
    fan_in = 8 * 9
    layer.reset_parameters(torch.Generator().manual_seed(0))
    w, b = layer.weight.detach(), layer.bias.detach()
    limit = np.sqrt(2.0) * np.sqrt(3.0 / fan_in)
    assert float(w.abs().max()) <= limit
    assert float(w.abs().max()) > 0.99 * limit
    assert abs(float(w.mean())) < 0.02 * limit
    assert abs(float(w.var()) - limit ** 2 / 3) < 0.05 * limit ** 2 / 3
    assert float(b.abs().max()) <= 1 / np.sqrt(fan_in)
    again = nn.Conv2D(16, 64, 3, groups=2, device='cpu')
    again.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.equal(again.weight, layer.weight)
    assert nn.Conv2D(3, 4, 1, bias_attr=False, device='cpu').bias is None
    jl = paddle.nn.Conv2D(16, 64, 3, groups=2, data_format='NHWC')
    assert set(jl.state_dict()) == set(layer.state_dict())


@pytest.mark.parametrize('nonlinearity,param', [
    ('relu', None), ('leaky_relu', 0.2), ('leaky_relu', 0.0), ('tanh', None),
    ('conv2d', None), ('selu', None)])
def test_initializer_laws_are_the_references(nonlinearity, param):
    """``calculate_gain`` equals the reference's (``leaky_relu`` with a
    slope of 0 takes 0.01, as there); ``KaimingUniform`` draws within
    ``gain * sqrt(3 / fan_in)`` and reaches it; ``Constant`` fills."""
    gain = initializer.calculate_gain(nonlinearity, param)
    assert gain == jax_init.calculate_gain(nonlinearity, param)
    limit = gain * np.sqrt(3.0 / 50)
    init = initializer.KaimingUniform(fan_in=50, negative_slope=param,
                                      nonlinearity=nonlinearity)
    w = init((400, 50), generator=torch.Generator().manual_seed(0))
    assert w.dtype == torch.float32
    assert limit * 0.99 < float(w.abs().max()) <= limit
    again = init((400, 50), generator=torch.Generator().manual_seed(0))
    assert torch.equal(w, again)
    c = initializer.Constant(0.5)((2, 3), dtype=torch.bfloat16)
    assert c.dtype == torch.bfloat16 and torch.equal(
        c, torch.full((2, 3), 0.5, dtype=torch.bfloat16))


def test_conv2d_layer_matches_jax_layer():
    paddle.seed(1)
    jl = paddle.nn.Conv2D(3, 6, 5, stride=2, padding='SAME',
                          data_format='NHWC')
    params = {k: np.array(v.value) for k, v in jl.state_dict().items()}
    tl = nn.Conv2D(3, 6, 5, stride=2, padding='SAME', data_format='NHWC',
                   device='cpu')
    tl.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    x = _rand(np.random.RandomState(2), 2, 11, 11, 3)
    want = _np(jl(paddle.to_tensor(x)).value)
    np.testing.assert_allclose(_np(tl(torch.from_numpy(x))), want, rtol=TOL,
                               atol=TOL)


def test_f32_conv_turns_tf32_off_forward_and_backward(monkeypatch):
    """An f32 conv runs, forward and backward, with cuDNN's TF32 off even
    when the process allows it, and the flag is restored after."""
    seen = []
    fwd, bwd = conv_mod._convolution, conv_mod._convolution_backward

    def spy_fwd(*args):
        seen.append(('fwd', torch.backends.cudnn.allow_tf32))
        return fwd(*args)

    def spy_bwd(*args):
        seen.append(('bwd', torch.backends.cudnn.allow_tf32))
        return bwd(*args)

    monkeypatch.setattr(conv_mod, '_convolution', spy_fwd)
    monkeypatch.setattr(conv_mod, '_convolution_backward', spy_bwd)
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', True)
    x = torch.randn(1, 2, 5, 5, requires_grad=True)
    w = torch.randn(3, 2, 3, 3, requires_grad=True)
    F.conv2d(x, w, padding=1).sum().backward()
    assert seen == [('fwd', False), ('bwd', False)]
    assert torch.backends.cudnn.allow_tf32 is True


def test_transposed_convs_and_masks_raise():
    """The calls that raised before the vision slice now run and agree
    with the reference: the three transposed convolutions, and the max
    pools with ``return_mask=True`` (the reference never reads the flag
    and returns the pooled tensor alone).  A padding string other than
    ``'SAME'``/``'VALID'`` still raises."""
    rs = np.random.RandomState(0)
    for n in (1, 2, 3):
        x, w = _rand(rs, 1, 2, *(4,) * n), _rand(rs, 2, 3, *(2,) * n)
        name = f'conv{n}d_transpose'
        _compare(lambda v, k: getattr(JF, name)(v, k, stride=2),
                 lambda v, k: getattr(F, name)(v, k, stride=2), [x, w])
    x = _rand(rs, 1, 1, 4, 4)
    _compare(lambda v: JF.max_pool2d(v, 2, return_mask=True),
             lambda v: F.max_pool2d(v, 2, return_mask=True), [x])
    _compare(lambda v: JF.adaptive_max_pool2d(v, 2, return_mask=True),
             lambda v: F.adaptive_max_pool2d(v, 2, return_mask=True), [x])
    with pytest.raises(ValueError):
        F.conv2d(torch.from_numpy(x), torch.zeros(1, 1, 1, 1),
                 padding='FULL')


# (kind, n, data_format, kernel, stride, padding, ceil_mode, exclusive)
POOL_CASES = [
    ('max', 2, 'NCHW', 3, 2, 1, False, True),
    ('max', 2, 'NHWC', 3, 2, 1, False, True),
    ('max', 2, 'NCHW', 2, 2, 0, True, True),
    ('max', 2, 'NHWC', 3, 2, [(0, 2), (1, 1)], True, True),
    ('max', 2, 'NCHW', 3, 1, 'SAME', False, True),
    ('max', 2, 'NCHW', 4, 3, 'VALID', True, True),
    ('max', 1, 'NCL', 3, 2, 1, True, True),
    ('max', 3, 'NDHWC', 2, 2, 1, False, True),
    ('avg', 2, 'NCHW', 3, 2, 1, False, True),
    ('avg', 2, 'NHWC', 3, 2, 1, True, True),
    ('avg', 2, 'NCHW', 3, 2, 1, True, False),
    ('avg', 2, 'NHWC', 2, 2, 'SAME', False, True),
    ('avg', 2, 'NCHW', 3, 3, 'VALID', True, False),
    ('avg', 1, 'NCL', 4, 3, 2, True, True),
    ('avg', 3, 'NCDHW', 3, 2, 1, False, True),
    ('avg', 3, 'NDHWC', 2, 2, 0, True, False),
]


@pytest.mark.parametrize('case', POOL_CASES, ids=lambda c: '-'.join(
    str(v).replace(' ', '') for v in c))
def test_pool_matches_jax(case):
    kind, n, df, k, s, padding, ceil, excl = case
    rs = np.random.RandomState(n)
    sp = (9,) * n if n < 3 else (6,) * n
    x = _rand(rs, 2, *sp, 3) if df[-1] == 'C' else _rand(rs, 2, 3, *sp)
    name = f'{kind}_pool{n}d'
    kw = dict(stride=s, padding=padding, ceil_mode=ceil)
    if kind == 'avg':
        kw['exclusive'] = excl
    if n > 1:
        kw['data_format'] = df
    jfn, tfn = getattr(JF, name), getattr(F, name)
    exact = kind == 'max'
    _compare(lambda v: jfn(v, k, **kw), lambda v: tfn(v, k, **kw), [x],
             tol=0 if exact else TOL, grad_tol=0 if exact else GRAD_TOL)


@pytest.mark.parametrize('df', ['NCHW', 'NHWC'])
def test_bf16_max_pool_tie_sends_the_gradient_where_jax_does(df):
    """Windows with tied maxima (bf16 rounds nearby values together):
    the gradient goes to the first maximum in row-major window order,
    as ``jax.grad`` of ``lax.reduce_window`` sends it."""
    x = np.zeros((1, 2, 6, 6), np.float32)
    x[0, 0] = 1.0                       # every element of channel 0 ties
    x[0, 1, 1, 1] = x[0, 1, 2, 2] = 3.0   # one tie across two windows
    x[0, 1, 4, 5] = 1.0 + 2 ** -10        # rounds to 1.0 in bf16: ties
    x[0, 1, 5, 4] = 1.0
    if df == 'NHWC':
        x = x.transpose(0, 2, 3, 1).copy()
    got, grads = _compare(
        lambda v: JF.max_pool2d(v, 3, 2, 1, data_format=df),
        lambda v: F.max_pool2d(v, 3, 2, 1, data_format=df), [x],
        dtype='bfloat16', tol=0, grad_tol=0)
    assert np.count_nonzero(grads[0]) < x.size


# (n, data_format, input spatial, output size)
ADAPTIVE_CASES = [
    (2, 'NCHW', (8, 8), (1, 1)),
    (2, 'NHWC', (7, 7), (1, 1)),
    (2, 'NCHW', (8, 6), (4, 3)),
    (2, 'NHWC', (7, 5), (3, 2)),     # uneven bins
    (1, 'NCL', (10,), 4),            # uneven
    (3, 'NCDHW', (4, 6, 5), (2, 3, 2)),
]


# adaptive_max_pool*d takes NC-first input only, as in the reference
@pytest.mark.parametrize('kind,case', [
    (kind, c) for kind in ('avg', 'max') for c in ADAPTIVE_CASES
    if kind == 'avg' or c[1][-1] != 'C'], ids=lambda c: '-'.join(
        str(v).replace(' ', '') for v in c) if isinstance(c, tuple) else c)
def test_adaptive_pool_matches_jax(kind, case):
    n, df, sp, out = case
    rs = np.random.RandomState(len(sp))
    x = _rand(rs, 2, *sp, 3) if df[-1] == 'C' else _rand(rs, 2, 3, *sp)
    name = f'adaptive_{kind}_pool{n}d'
    jfn, tfn = getattr(JF, name), getattr(F, name)
    if kind == 'avg' and n > 1:
        jf, tf = (lambda v: jfn(v, out, data_format=df),
                  lambda v: tfn(v, out, data_format=df))
    else:
        jf, tf = lambda v: jfn(v, out), lambda v: tfn(v, out)
    _compare(jf, tf, [x], tol=0 if kind == 'max' else TOL,
             grad_tol=0 if kind == 'max' else GRAD_TOL)


def test_adaptive_max_ties_split_the_gradient_as_jax():
    x = np.ones((1, 1, 4, 4), np.float32)
    _, grads = _compare(lambda v: JF.adaptive_max_pool2d(v, 2),
                        lambda v: F.adaptive_max_pool2d(v, 2), [x],
                        tol=0, grad_tol=0)
    assert np.count_nonzero(grads[0]) == 16


def test_pool_layers_match_functionals():
    x = torch.randn(2, 9, 9, 3)
    torch.testing.assert_close(
        nn.MaxPool2D(3, 2, 1, data_format='NHWC')(x),
        F.max_pool2d(x, 3, 2, 1, data_format='NHWC'))
    torch.testing.assert_close(
        nn.AvgPool2D(2, ceil_mode=True, exclusive=False,
                     data_format='NHWC')(x),
        F.avg_pool2d(x, 2, ceil_mode=True, exclusive=False,
                     data_format='NHWC'))
    torch.testing.assert_close(
        nn.AdaptiveAvgPool2D((1, 1), data_format='NHWC')(x),
        x.mean(dim=(1, 2), keepdim=True))


@pytest.mark.parametrize('name', ['relu', 'relu6'])
def test_relu_matches_jax_at_the_kinks(name):
    x = np.array([[-1.0, 0.0, 0.5, 6.0, 7.0, 3.0]], np.float32)
    _, grads = _compare(lambda v: getattr(JF, name)(v),
                        lambda v: getattr(F, name)(v), [x], tol=0,
                        grad_tol=0)
    layer = nn.ReLU() if name == 'relu' else nn.ReLU6()
    torch.testing.assert_close(layer(torch.from_numpy(x)),
                               getattr(F, name)(torch.from_numpy(x)))


def _empty_grads(out, args):
    """Gradients of ``sum(out)`` for an output with no elements."""
    assert out.numel() == 0
    grads = torch.autograd.grad(out.float().sum(), args, allow_unused=True)
    return [_np(torch.zeros_like(a) if g is None else g)
            for a, g in zip(args, grads)]


# (n, data_format, input shape, weight shape, padding, dilation, bias,
#  dtype): each window is larger than the padded input
EMPTY_CONV_CASES = [
    (2, 'NCHW', (1, 1, 2, 2), (1, 1, 3, 3), 0, 1, True, 'float32'),
    (2, 'NHWC', (2, 2, 2, 3), (4, 3, 3, 3), 0, 1, False, 'float32'),
    (2, 'NCHW', (1, 2, 3, 3), (2, 2, 3, 3), 0, 2, True, 'bfloat16'),
    (1, 'NLC', (1, 4, 2), (3, 2, 3), 0, 2, False, 'float32'),
    (1, 'NCL', (2, 2, 1), (3, 2, 3), [(0, 1)], 1, True, 'float32'),
    (3, 'NCDHW', (1, 1, 2, 4, 4), (2, 1, 3, 3, 3), 0, 1, True, 'float32'),
]


@pytest.mark.parametrize('case', EMPTY_CONV_CASES, ids=lambda c: '-'.join(
    str(v).replace(' ', '') for v in c))
def test_conv_window_larger_than_padded_input_is_empty_as_in_jax(case):
    """XLA gives such a convolution an empty output (and ``jax.grad``
    zero gradients); the port returns the same empty result before
    any launch."""
    n, df, xs, ws, padding, dilation, bias, dtype = case
    rs = np.random.RandomState(n)
    arrays = [_rand(rs, *xs), _rand(rs, *ws)] + (
        [_rand(rs, ws[0])] if bias else [])
    jconv = getattr(JF, f'conv{n}d')
    tconv = getattr(F, f'conv{n}d')
    kw = dict(padding=padding, dilation=dilation, data_format=df)
    jd = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
    td = torch.bfloat16 if dtype == 'bfloat16' else torch.float32
    jargs = [jnp.asarray(a).astype(jd) for a in arrays]

    def jfn(*vals):
        with jax_no_grad():
            out = jconv(*[JaxTensor._from_value(v) for v in vals],
                        **kw).value
        return jnp.sum(out.astype(jnp.float32)), out

    (_, want), want_g = jax.value_and_grad(
        jfn, argnums=tuple(range(len(jargs))), has_aux=True)(*jargs)
    targs = [torch.from_numpy(a).to(td).requires_grad_(True)
             for a in arrays]
    got = tconv(*targs, **kw)
    assert tuple(got.shape) == tuple(want.shape)
    assert 0 in got.shape
    assert str(got.dtype).replace('torch.', '') == str(want.dtype)
    for g, w in zip(_empty_grads(got, targs), want_g):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, _np(w))
        assert not g.any()


# (kind, data_format, input shape, kernel, stride, padding, ceil_mode)
EMPTY_POOL_CASES = [
    ('max', 'NCHW', (1, 1, 2, 2), 3, None, 0, False),
    ('avg', 'NCHW', (1, 1, 2, 2), 3, None, 0, False),
    ('max', 'NHWC', (2, 2, 2, 3), 3, 1, 0, True),
    ('avg', 'NHWC', (2, 2, 2, 3), 3, 1, 0, True),
    ('max', 'NCHW', (1, 2, 2, 5), 4, 1, [(0, 1), (0, 0)], True),
    ('avg', 'NCHW', (1, 2, 2, 5), 4, 1, [(0, 1), (0, 0)], False),
]


@pytest.mark.parametrize('case', EMPTY_POOL_CASES, ids=lambda c: '-'.join(
    str(v).replace(' ', '') for v in c))
def test_pool_window_larger_than_padded_input_is_empty_as_in_jax(case):
    kind, df, xs, k, s, padding, ceil = case
    x = _rand(np.random.RandomState(1), *xs)
    name = f'{kind}_pool2d'
    kw = dict(stride=s, padding=padding, ceil_mode=ceil, data_format=df)
    (_, want), (want_g,) = jax.value_and_grad(
        lambda v: (lambda o: (jnp.sum(o), o))(
            getattr(JF, name)(JaxTensor._from_value(v), k, **kw).value),
        argnums=(0,), has_aux=True)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = getattr(F, name)(tx, k, **kw)
    assert tuple(got.shape) == tuple(want.shape) and 0 in got.shape
    assert got.dtype == torch.float32
    (g,) = _empty_grads(got, [tx])
    np.testing.assert_array_equal(g, _np(want_g))
    assert not g.any()


@pytest.mark.parametrize('n,pairs', [(3, 5), (2, 1), (2, 3), (1, 2)])
def test_conv_padding_list_of_the_wrong_length_raises_in_both(n, pairs):
    """``lax.conv_general_dilated`` refuses another number of (low,
    high) pairs than spatial axes; so does the port (the exception
    types differ)."""
    x = np.ones((1, 1) + (5,) * n, np.float32)
    w = np.ones((1, 1) + (3,) * n, np.float32)
    pad = [(1, 1)] * pairs
    with pytest.raises(Exception):
        getattr(JF, f'conv{n}d')(paddle.to_tensor(x), paddle.to_tensor(w),
                                 padding=pad)
    with pytest.raises((TypeError, ValueError)):
        getattr(F, f'conv{n}d')(torch.from_numpy(x), torch.from_numpy(w),
                                padding=pad)


def test_pool_reads_the_first_n_padding_pairs_as_jax_does():
    """The reference's pools read the first ``n`` pairs of a longer
    list and fail on a shorter one; so do the port's."""
    x = _rand(np.random.RandomState(2), 1, 2, 6, 6)
    kw = dict(padding=[(1, 0), (0, 1), (5, 5)], ceil_mode=True)
    for name in ('max_pool2d', 'avg_pool2d'):
        want = _np(getattr(JF, name)(paddle.to_tensor(x), 3, 2, **kw))
        got = _np(getattr(F, name)(torch.from_numpy(x), 3, 2, **kw))
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        with pytest.raises(Exception):
            getattr(JF, name)(paddle.to_tensor(x), 3, 2, padding=[(1, 1)])
        with pytest.raises(ValueError, match='padding pairs'):
            getattr(F, name)(torch.from_numpy(x), 3, 2, padding=[(1, 1)])


@pytest.mark.parametrize('kind', ['max', 'avg'])
def test_ceil_mode_window_wholly_in_padding_agrees_element_for_element(kind):
    """kernel 2, stride 3, padding 1 on 7 x 7 with ``ceil_mode``: the
    last window of each axis lies wholly in the high padding, so it is
    ``-inf`` (max) or NaN (exclusive average, 0 / 0) in both packages,
    element for element, and the gradients agree."""
    x = _rand(np.random.RandomState(4), 2, 3, 7, 7)
    name = f'{kind}_pool2d'
    kw = dict(stride=3, padding=1, ceil_mode=True)
    cot = np.random.RandomState(5).randn(2, 3, 4, 4).astype(np.float32)
    want, (want_g,) = _jax_vjp(lambda v: getattr(JF, name)(v, 2, **kw),
                               [jnp.asarray(x)], cot)
    got, (got_g,) = _torch_vjp(lambda v: getattr(F, name)(v, 2, **kw),
                               [torch.from_numpy(x)], cot)
    assert got.shape == want.shape == (2, 3, 4, 4)
    last = want[:, :, -1, :], want[:, :, :, -1]
    if kind == 'max':
        assert all(np.isneginf(v).all() for v in last)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_g, want_g)
    else:
        assert all(np.isnan(v).all() for v in last)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got_g, want_g, rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
    assert np.isfinite(want[:, :, :-1, :-1]).all()
