"""The port's transposed convolutions and the conv layers' repairs
against the JAX package's, on the CPU.

The same seeded numpy inputs go through both packages
(``torch_tensor_oracle.check``: outputs within 2e-5, every input's
gradient within 1e-4 in f32; bf16 cases 2e-2 of the output's scale).
The cases cover the reference's whole signature: 1-, 2- and 3-d,
groups, dilation, ``output_padding`` (below the stride, which PyTorch's
own padding takes, and at or above it, which it cannot), asymmetric
``[[lo, hi], ...]`` pairs and ``'SAME'``/``'VALID'`` (cropped from an
unpadded transpose), ``output_size`` (one-sided extra padding, a
``ValueError`` in both packages when out of reach), NCHW and NHWC, with
and without bias.

Then the conv layers: ``Conv*DTranspose`` with the reference's
``[in, out/groups, *k]`` weight and ``forward(x, output_size)``, and
the three faults the port's ``_ConvNd`` had, each of
which raised where the reference builds: ``padding_mode`` other than
``'zeros'`` (taken and not read, so the layer pads with zeros),
``weight_attr`` and a ``bias_attr`` that is a ``ParamAttr``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F
from torch_seq_oracle import compare_vjp, load_from_jax
from torch_tensor_oracle import check

BF16_TOL = 2e-2


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device('cpu')
    yield
    paddle.set_device(None)


def _rand(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


# (n, data_format, cin, cout, k, stride, padding, output_padding, groups,
#  dilation, bias, output_size)
CASES = [
    (2, 'NCHW', 4, 6, 3, 1, 0, 0, 1, 1, True, None),
    (2, 'NCHW', 4, 6, 5, 2, 2, 1, 1, 1, True, None),        # DCGAN's
    (2, 'NHWC', 4, 6, 5, 2, 2, 1, 1, 1, False, None),
    (2, 'NCHW', 4, 6, 3, 2, 1, 0, 2, 1, True, None),
    (2, 'NHWC', 4, 4, 3, 1, 1, 0, 4, 2, True, None),
    (2, 'NCHW', 4, 6, 3, 2, [(0, 2), (1, 0)], 1, 2, 1, True, None),
    (2, 'NHWC', 4, 6, 3, 2, [1, 2, 0, 1], 0, 1, 1, False, None),
    (2, 'NCHW', 4, 6, 4, 2, 'SAME', 0, 1, 1, True, None),
    (2, 'NCHW', 4, 6, 3, 3, 'VALID', 0, 1, 2, True, None),
    (2, 'NCHW', 4, 6, 3, 1, 1, 2, 1, 1, True, None),        # opad >= stride
    (2, 'NCHW', 4, 6, 3, 2, 1, 0, 1, 1, True, [13, 14]),
    (2, 'NHWC', 4, 6, 3, 3, [(1, 0), (0, 1)], 0, 2, 1, True, 22),
    (1, 'NCL', 4, 6, 3, 2, 1, 1, 1, 1, True, None),
    (1, 'NLC', 4, 6, 3, 2, [(2, 0)], 0, 2, 2, False, None),
    (1, 'NCL', 4, 6, 4, 3, 0, 0, 1, 1, True, 24),
    (3, 'NCDHW', 4, 6, 3, 2, 1, 1, 1, 1, True, None),
    (3, 'NDHWC', 4, 6, 2, 2, 'SAME', 0, 2, 1, False, None),
    (3, 'NCDHW', 2, 4, 3, 1, [(1, 0), (0, 1), (1, 1)], 0, 1, 2, True, None),
]


def _case_arrays(case, rs):
    n, df, cin, cout, k, *_, groups, _, _, _ = case
    size = 7 if n < 3 else 4
    sp = (size,) * n
    x = _rand(rs, 2, *sp, cin) if df[-1] == 'C' else _rand(rs, 2, cin, *sp)
    w = _rand(rs, cin, cout // groups, *(k,) * n, scale=0.3)
    return x, w, _rand(rs, cout)


def _fn(case):
    n, df, _, _, _, stride, padding, opad, groups, dilation, bias, osize = \
        case
    name = f'conv{n}d_transpose'
    kw = dict(stride=stride, padding=padding, output_padding=opad,
              groups=groups, dilation=dilation, output_size=osize,
              data_format=df)
    if bias:
        return lambda P, x, w, b: getattr(P.nn.functional, name)(
            x, w, b, **kw)
    return lambda P, x, w: getattr(P.nn.functional, name)(x, w, **kw)


@pytest.mark.parametrize('case', CASES, ids=lambda c: '-'.join(
    str(v).replace(' ', '') for v in c))
def test_conv_transpose_matches_jax(case):
    x, w, b = _case_arrays(case, np.random.RandomState(len(str(case))))
    arrays = [x, w, b] if case[10] else [x, w]
    out = check(_fn(case), arrays, what=str(case))[0]
    if case[-1] is not None:
        want = case[-1] if isinstance(case[-1], list) else [case[-1]] * case[0]
        sp = out.shape[1:-1] if case[1][-1] == 'C' else out.shape[2:]
        assert list(sp) == want


def test_conv_transpose_bf16_and_under_o2():
    """bf16 inputs against the reference's bf16 (no bias: its gradient
    is a bf16 sum of 2700 elements, which the two packages round at
    other places); f32 inputs under O2 (white-listed: cast to bf16)
    equal the bf16 call."""
    case = CASES[2]
    x, w, _ = _case_arrays(case, np.random.RandomState(1))
    fn = _fn(case)
    got = check(lambda P, x, w: P.cast(fn(P, *[
        P.cast(t, 'bfloat16') for t in (x, w)]), 'float32'),
        [x, w], tol=BF16_TOL, grad_tol=BF16_TOL)[0]
    with paddle.amp.auto_cast(level='O2'):
        out = fn(paddle, *[torch.from_numpy(a) for a in (x, w)])
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.float(), got.detach())


@pytest.mark.parametrize('n', [1, 2, 3])
def test_unreachable_output_size_raises_in_both(n):
    rs = np.random.RandomState(n)
    x = _rand(rs, 1, 2, *(5,) * n)
    w = _rand(rs, 2, 3, *(3,) * n)
    name = f'conv{n}d_transpose'
    for P, wrap in ((jpaddle, jpaddle.to_tensor), (paddle, torch.from_numpy)):
        fn = getattr(P.nn.functional, name)
        with pytest.raises(ValueError, match='not reachable'):
            fn(wrap(x), wrap(w), stride=2, output_size=[20] * n)
        with pytest.raises(ValueError, match='not reachable'):
            fn(wrap(x), wrap(w), stride=2, output_size=[9] * n)


def test_conv_transpose_uses_the_f32_guard(monkeypatch):
    """The transposed product runs with cuDNN's TF32 off, forward and
    backward, as the convolution does."""
    conv_mod = __import__('paddle_tpu_torch.nn.functional.conv',
                          fromlist=['_convolution'])
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
    w = torch.randn(2, 3, 3, 3, requires_grad=True)
    F.conv2d_transpose(x, w, stride=2, padding=[(0, 1), (1, 0)]).sum() \
        .backward()
    assert seen == [('fwd', False), ('bwd', False)]
    assert torch.backends.cudnn.allow_tf32 is True


@pytest.mark.parametrize('n,df', [(1, 'NCL'), (2, 'NHWC'), (3, 'NCDHW')])
def test_conv_transpose_layers_match_jax(n, df):
    """``Conv*DTranspose`` with the reference's weights: the state-dict
    keys and the ``[in, out/groups, *k]`` shape, output and every
    gradient, ``forward(x, output_size)``."""
    name = f'Conv{n}DTranspose'
    kw = dict(stride=2, padding=1, groups=2, data_format=df)
    jpaddle.seed(n)
    jm = getattr(jpaddle.nn, name)(4, 6, 3, **kw)
    pm = getattr(nn, name)(4, 6, 3, **kw)
    assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} == {
        'weight': (4, 3) + (3,) * n, 'bias': (6,)}
    load_from_jax(pm, jm)
    size = 5 if n < 3 else 3
    sp = (size,) * n
    x = _rand(np.random.RandomState(0), 2, *((*sp, 4) if df[-1] == 'C'
                                            else (4, *sp)))
    osize = [2 * size] * n
    compare_vjp(jm, pm, lambda m, v: m(v, output_size=osize), [x], 2e-5,
                1e-4)


def test_conv_layer_init_draws_the_reference_laws():
    """The layers draw at construction: ``KaimingUniform(fan_in)``
    weights within ``sqrt(6 / fan_in)`` and ``Uniform(+-1/sqrt(fan_in))``
    bias, ``fan_in = in/groups * prod(k)`` for both kinds, as the
    reference's ``_ConvNd``."""
    paddle.seed(0)
    for layer, fan_in in ((nn.Conv2D(16, 32, 3, groups=2), 8 * 9),
                          (nn.Conv2DTranspose(16, 32, 3, groups=2), 8 * 9),
                          (nn.Conv1DTranspose(6, 4, 5), 30)):
        w, b = layer.weight.detach(), layer.bias.detach()
        limit = np.sqrt(6.0 / fan_in)
        assert 0.9 * limit < float(w.abs().max()) <= limit
        assert 0 < float(b.abs().max()) <= 1 / np.sqrt(fan_in)
    assert tuple(nn.Conv2DTranspose(16, 32, 3, groups=2).weight.shape) == \
        (16, 16, 3, 3)


def test_conv_padding_mode_is_taken_and_not_read_as_in_the_reference():
    """``padding_mode='reflect'`` raised in the port; the reference
    builds the layer and pads with zeros, and so does the port now."""
    jpaddle.seed(2)
    jm = jpaddle.nn.Conv2D(3, 5, 3, padding=1, padding_mode='reflect')
    pm = nn.Conv2D(3, 5, 3, padding=1, padding_mode='reflect')
    load_from_jax(pm, jm)
    zeros = nn.Conv2D(3, 5, 3, padding=1)
    zeros.load_state_dict(pm.state_dict())
    x = _rand(np.random.RandomState(1), 2, 3, 6, 6)
    compare_vjp(jm, pm, lambda m, v: m(v), [x], 2e-5, 1e-4)
    torch.testing.assert_close(pm(torch.from_numpy(x)),
                               zeros(torch.from_numpy(x)), rtol=0, atol=0)


def test_conv_weight_and_bias_attrs_as_in_the_reference():
    """``weight_attr`` (an initializer or a ``ParamAttr``) and a
    ``ParamAttr`` ``bias_attr`` raised in the port; now they take the
    ``create_parameter`` path ``Linear`` takes, as the reference's do:
    the initializer fills, ``learning_rate`` and ``trainable`` land on
    the parameter."""
    init = paddle.nn.initializer
    pm = nn.Conv2D(2, 3, 3, weight_attr=init.Constant(0.25),
                   bias_attr=paddle.ParamAttr(
                       initializer=init.Constant(-1.0), learning_rate=0.5,
                       trainable=False))
    jm = jpaddle.nn.Conv2D(2, 3, 3, weight_attr=jpaddle.nn.initializer
                           .Constant(0.25), bias_attr=jpaddle.ParamAttr(
                               initializer=jpaddle.nn.initializer
                               .Constant(-1.0), learning_rate=0.5,
                               trainable=False))
    for name in ('weight', 'bias'):
        np.testing.assert_array_equal(
            getattr(pm, name).detach().numpy(),
            np.asarray(getattr(jm, name).value))
    assert pm.bias.optimize_attr == {'learning_rate': 0.5}
    assert not pm.bias.requires_grad and pm.weight.requires_grad
    t = nn.Conv2DTranspose(2, 4, 2, weight_attr=init.Bilinear(),
                           bias_attr=False)
    jt = jpaddle.nn.Conv2DTranspose(2, 4, 2, weight_attr=jpaddle.nn
                                    .initializer.Bilinear(), bias_attr=False)
    assert t.bias is None and jt.bias is None
    np.testing.assert_array_equal(t.weight.detach().numpy(),
                                  np.asarray(jt.weight.value))
