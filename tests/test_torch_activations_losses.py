"""The port's activations and losses against the JAX package's, on the
CPU: every functional and layer of ``nn/functional/activation.py``,
``nn/layer/activation.py``, ``nn/functional/loss.py`` and
``nn/layer/loss.py``.

The same seeded numpy inputs go through the JAX function (under
``jax.value_and_grad``) and the port's (``backward``); the cotangent is
a seeded random tensor of the output's shape, and the gradient is taken
for every float input (labels are constants).  Tolerances, relative to
the largest magnitude of the JAX result: f32 forward 2e-5 and gradients
1e-4 (sums in another order than XLA's); bf16 2e-2 (both round f32
results to bf16, at other places).  ``gumbel_softmax`` draws noise, so
its cases check what holds for any draw.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.core.autograd import no_grad as jax_no_grad
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.nn import functional as JF
import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F

TOL, GRAD_TOL, BF16_TOL = 2e-5, 1e-4, 2e-2


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device('cpu')
    yield
    paddle.set_device(None)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _cot(shape, seed):
    return np.asarray(np.random.RandomState(seed).randn(*shape), np.float32)


def _jax_vjp(fn, diff, const, cot_seed=7):
    """(output, gradients of the ``diff`` inputs) of ``sum(fn(*diff,
    *const) * cot)`` by jax.grad."""
    const = [JaxTensor._from_value(jnp.asarray(c)) for c in const]

    def f(*vals):
        with jax_no_grad():
            out = fn(*[JaxTensor._from_value(v) for v in vals], *const)
        out = out.value
        return jnp.sum(out.astype(jnp.float32) * _cot(out.shape,
                                                      cot_seed)), out

    (_, out), grads = jax.value_and_grad(
        f, argnums=tuple(range(len(diff))), has_aux=True)(
            *[jnp.asarray(d) for d in diff])
    return _np(out), [_np(g) for g in grads]


def _torch_vjp(fn, diff, const, cot_seed=7):
    ts = [torch.from_numpy(np.asarray(d)).requires_grad_(True) for d in diff]
    cs = [torch.from_numpy(np.asarray(c)) for c in const]
    out = fn(*ts, *cs)
    (out.float() * torch.from_numpy(_cot(out.shape, cot_seed))).sum() \
        .backward()
    return _np(out), [_np(t.grad) for t in ts]


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f'{what}: max |diff| / scale {err:.3e} > {tol}'


def _compare(jfn, tfn, diff, const=(), tol=TOL, grad_tol=GRAD_TOL):
    want, jgrads = _jax_vjp(jfn, diff, const)
    got, tgrads = _torch_vjp(tfn, diff, const)
    assert got.shape == want.shape
    _close(got, want, tol, 'forward')
    for i, (g, w) in enumerate(zip(tgrads, jgrads)):
        _close(g, w, grad_tol, f'gradient {i}')


def _x(*shape, seed=0, scale=2.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# (name, kwargs, shape); every functional of the reference's activation
# module but gumbel_softmax (random) and the in-place forms (below)
ACTIVATIONS = [
    ('relu', {}, (4, 9)), ('relu6', {}, (4, 9)), ('gelu', {}, (4, 9)),
    ('gelu', {'approximate': True}, (4, 9)), ('sigmoid', {}, (4, 9)),
    ('softmax', {}, (4, 9)), ('softmax', {'axis': 0}, (4, 9)),
    ('log_softmax', {}, (4, 9)), ('log_softmax', {'axis': 1}, (3, 4, 5)),
    ('tanh', {}, (4, 9)), ('leaky_relu', {}, (4, 9)),
    ('leaky_relu', {'negative_slope': 0.2}, (4, 9)), ('elu', {}, (4, 9)),
    ('elu', {'alpha': 0.5}, (4, 9)), ('selu', {}, (4, 9)),
    ('celu', {'alpha': 1.5}, (4, 9)), ('hardswish', {}, (4, 9)),
    ('hardsigmoid', {}, (4, 9)), ('swish', {}, (4, 9)), ('silu', {}, (4, 9)),
    ('mish', {}, (4, 9)), ('softplus', {}, (4, 9)),
    ('softplus', {'beta': 2.0, 'threshold': 3.0}, (4, 9)),
    ('softsign', {}, (4, 9)), ('hardtanh', {}, (4, 9)),
    ('hardtanh', {'min': -0.5, 'max': 2.0}, (4, 9)),
    ('hardshrink', {}, (4, 9)), ('softshrink', {'threshold': 0.3}, (4, 9)),
    ('tanhshrink', {}, (4, 9)), ('thresholded_relu', {}, (4, 9)),
    ('log_sigmoid', {}, (4, 9)), ('glu', {}, (4, 8)),
    ('glu', {'axis': 0}, (6, 3)), ('maxout', {'groups': 2}, (2, 6, 3)),
    ('maxout', {'groups': 3, 'axis': -1}, (2, 6)),
]


@pytest.mark.parametrize('name,kw,shape', ACTIVATIONS,
                         ids=[f'{n}-{i}' for i, (n, _, _) in
                              enumerate(ACTIVATIONS)])
def test_activation_matches_jax(name, kw, shape):
    _compare(lambda x: getattr(JF, name)(x, **kw),
             lambda x: getattr(F, name)(x, **kw), [_x(*shape)])


BF16_ACTIVATIONS = ['relu', 'gelu', 'sigmoid', 'tanh', 'silu', 'softplus',
                    'log_softmax', 'leaky_relu', 'elu', 'hardswish', 'mish',
                    'softsign', 'log_sigmoid']


@pytest.mark.parametrize('name', BF16_ACTIVATIONS)
def test_activation_bf16_matches_jax(name):
    """bf16 in, bf16 out in both (no AMP)."""
    x = _x(4, 9)
    want, jg = _jax_vjp(lambda v: getattr(JF, name)(v), [
        jnp.asarray(x, jnp.bfloat16)], [])
    t = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    out = getattr(F, name)(t)
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(_cot(out.shape, 7))).sum().backward()
    _close(_np(out), want, BF16_TOL, 'bf16 forward')
    _close(_np(t.grad), jg[0], BF16_TOL, 'bf16 gradient')


@pytest.mark.parametrize('data_format,shape', [('NCHW', (2, 3, 4, 4)),
                                               ('NHWC', (2, 4, 4, 3))])
@pytest.mark.parametrize('n', [1, 3])
def test_prelu_matches_jax(data_format, shape, n):
    w = np.array([0.25, -0.5, 0.1][:n], np.float32)
    _compare(lambda x, ww: JF.prelu(x, ww, data_format),
             lambda x, ww: F.prelu(x, ww, data_format), [_x(*shape), w])


@pytest.mark.parametrize('name', ['relu_', 'elu_', 'softmax_'])
def test_inplace_activation_writes_its_input(name):
    """The in-place forms give the functional's values, in ``x`` itself,
    and pass the gradient through."""
    x = _x(4, 9)
    base = name[:-1]
    want, jg = _jax_vjp(lambda v: getattr(JF, base)(v), [x], [])
    t = torch.from_numpy(x).requires_grad_(True)
    y = t * 1.0
    out = getattr(F, name)(y)
    assert out is y
    (out * torch.from_numpy(_cot(out.shape, 7))).sum().backward()
    _close(_np(out), want, TOL, 'forward')
    _close(_np(t.grad), jg[0], GRAD_TOL, 'gradient')


@pytest.mark.parametrize('hard', [False, True])
def test_gumbel_softmax_draws_a_distribution(hard):
    paddle.seed(3)
    x = torch.from_numpy(_x(5, 7)).requires_grad_(True)
    y = F.gumbel_softmax(x, temperature=0.5, hard=hard)
    assert torch.allclose(y.sum(-1), torch.ones(5))
    if hard:
        assert set(torch.unique(y.detach()).tolist()) <= {0.0, 1.0}
    y[:, 0].sum().backward()
    assert x.grad.abs().sum() > 0
    paddle.seed(3)
    again = F.gumbel_softmax(x.detach(), temperature=0.5, hard=hard)
    assert torch.equal(again, y.detach())
    jy = JF.gumbel_softmax(jpaddle.to_tensor(_x(5, 7)), 0.5, hard)
    assert np.allclose(np.asarray(jy.value).sum(-1), 1.0, atol=1e-5)


# every activation layer: its functional with the layer's arguments
LAYERS = [
    ('ReLU', (), {}), ('ReLU6', (), {}), ('GELU', (True,), {}),
    ('Sigmoid', (), {}), ('Softmax', (0,), {}), ('LogSoftmax', (), {}),
    ('Tanh', (), {}), ('LeakyReLU', (0.3,), {}), ('ELU', (0.7,), {}),
    ('SELU', (), {}), ('CELU', (), {'alpha': 2.0}), ('Hardswish', (), {}),
    ('Hardsigmoid', (), {}), ('Swish', (), {}), ('Silu', (), {}),
    ('Mish', (), {}), ('Softplus', (2.0, 5.0), {}), ('Softsign', (), {}),
    ('Hardtanh', (-2.0, 0.5), {}), ('Hardshrink', (0.7,), {}),
    ('Softshrink', (), {'threshold': 0.2}), ('Tanhshrink', (), {}),
    ('LogSigmoid', (), {}), ('Maxout', (2,), {}),
    ('ThresholdedReLU', (0.4,), {}), ('GLU', (), {'axis': 1}),
]


@pytest.mark.parametrize('cls,args,kw', LAYERS, ids=[c for c, _, _ in LAYERS])
def test_activation_layer_matches_jax(cls, args, kw):
    jl = getattr(jpaddle.nn, cls)(*args, **kw)
    tl = getattr(nn, cls)(*args, **kw)
    _compare(lambda x: jl(x), lambda x: tl(x), [_x(2, 4, 3)])


def test_prelu_layer_matches_jax():
    jl = jpaddle.nn.PReLU(3, 0.1)
    tl = nn.PReLU(3, 0.1)
    assert np.array_equal(np.asarray(jl.weight.value), _np(tl.weight))
    assert list(tl.state_dict()) == ['weight']
    _compare(lambda x: jl(x), lambda x: tl(x), [_x(2, 3, 4, 4)])


# -- losses -----------------------------------------------------------

def _labels(shape, n, seed=1, ignore=None):
    lab = np.random.RandomState(seed).randint(0, n, shape).astype(np.int64)
    if ignore is not None:
        lab.reshape(-1)[::4] = ignore
    return lab


def _probs(*shape, seed=0):
    return np.random.RandomState(seed).uniform(
        0.05, 0.95, shape).astype(np.float32)


def _soft(*shape, seed=2):
    p = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    return p / p.sum(-1, keepdims=True)


def _pm1(*shape, seed=3):
    return np.where(np.random.RandomState(seed).rand(*shape) < 0.5, -1.0,
                    1.0).astype(np.float32)


W5 = np.array([0.5, 1.0, 2.0, 0.3, 1.5], np.float32)

# (case id, functional name, float inputs, constants, kwargs): the float
# inputs come first in the call, then the constants
LOSSES = [
    ('ce', 'cross_entropy', [_x(6, 5)], [_labels((6,), 5)], {}),
    ('ce_col_label_sum', 'cross_entropy', [_x(6, 5)], [_labels((6, 1), 5)],
     {'reduction': 'sum'}),
    ('ce_ignore_none', 'cross_entropy', [_x(2, 4, 5)],
     [_labels((2, 4), 5, ignore=-100)], {'reduction': 'none'}),
    ('ce_ignore_mean', 'cross_entropy', [_x(8, 5)],
     [_labels((8,), 5, ignore=-100)], {}),
    ('ce_weight_mean', 'cross_entropy', [_x(8, 5)],
     [_labels((8,), 5, ignore=-100), W5], {}),
    ('ce_weight_sum', 'cross_entropy', [_x(8, 5)],
     [_labels((8,), 5), W5], {'reduction': 'sum'}),
    ('ce_soft', 'cross_entropy', [_x(6, 5), _soft(6, 5)], [],
     {'soft_label': True}),
    ('ce_soft_weight_none', 'cross_entropy', [_x(6, 5), _soft(6, 5)], [W5],
     {'soft_label': True, 'reduction': 'none'}),
    ('ce_probs', 'cross_entropy', [_soft(6, 5, seed=4)], [_labels((6,), 5)],
     {'use_softmax': False}),
    ('ce_probs_soft', 'cross_entropy', [_soft(6, 5, seed=4), _soft(6, 5)],
     [], {'use_softmax': False, 'soft_label': True}),
    ('ce_axis1', 'cross_entropy', [_x(3, 5, 1)], [_labels((3, 1), 5)],
     {'axis': 1}),
    ('ce_axis1_probs', 'cross_entropy', [_soft(3, 5, seed=4)[..., None]],
     [_labels((3, 1), 5)], {'axis': 1, 'use_softmax': False}),
    ('swce', 'softmax_with_cross_entropy', [_x(6, 5)], [_labels((6, 1), 5)],
     {}),
    ('swce_soft', 'softmax_with_cross_entropy', [_x(6, 5), _soft(6, 5)], [],
     {'soft_label': True}),
    ('bce', 'binary_cross_entropy', [_probs(4, 6), _probs(4, 6, seed=2)],
     [], {}),
    ('bce_weight_sum', 'binary_cross_entropy', [_probs(4, 6)],
     [_probs(4, 6, seed=2), _probs(4, 6, seed=5)], {'reduction': 'sum'}),
    ('bce_logits', 'binary_cross_entropy_with_logits', [_x(4, 6)],
     [_probs(4, 6, seed=2)], {}),
    ('bce_logits_weight', 'binary_cross_entropy_with_logits', [_x(4, 6)],
     [_probs(4, 6, seed=2), _probs(4, 6, seed=5)], {'reduction': 'none'}),
    ('mse', 'mse_loss', [_x(4, 6), _x(4, 6, seed=1)], [], {}),
    ('mse_none', 'mse_loss', [_x(4, 6), _x(4, 6, seed=1)], [],
     {'reduction': 'none'}),
    ('square_error_cost', 'square_error_cost', [_x(4, 6), _x(4, 6, seed=1)],
     [], {}),
    ('l1', 'l1_loss', [_x(4, 6), _x(4, 6, seed=1)], [], {}),
    ('l1_sum', 'l1_loss', [_x(4, 6), _x(4, 6, seed=1)], [],
     {'reduction': 'sum'}),
    ('nll', 'nll_loss', [_x(6, 5)], [_labels((6,), 5)], {}),
    ('nll_4d_weight', 'nll_loss', [_x(2, 5, 3, 3)],
     [_labels((2, 3, 3), 5, ignore=-100), W5], {}),
    ('nll_weight_none', 'nll_loss', [_x(6, 5)],
     [_labels((6,), 5), W5], {'reduction': 'none'}),
    ('kl_div', 'kl_div', [_x(4, 5), _soft(4, 5)], [], {}),
    ('kl_div_batchmean', 'kl_div', [_x(4, 5), _soft(4, 5)], [],
     {'reduction': 'batchmean'}),
    ('kl_div_none', 'kl_div', [_x(4, 5), _soft(4, 5)], [],
     {'reduction': 'none'}),
    ('smooth_l1', 'smooth_l1_loss', [_x(4, 6), _x(4, 6, seed=1)], [], {}),
    ('smooth_l1_delta', 'smooth_l1_loss', [_x(4, 6), _x(4, 6, seed=1)], [],
     {'delta': 2.0, 'reduction': 'sum'}),
    ('margin_ranking', 'margin_ranking_loss', [_x(8), _x(8, seed=1)],
     [_pm1(8)], {'margin': 0.3}),
    ('hinge_embedding', 'hinge_embedding_loss', [_x(8)], [_pm1(8)], {}),
    ('cosine_embedding', 'cosine_embedding_loss', [_x(6, 4), _x(6, 4, seed=1)],
     [_pm1(6)], {'margin': 0.1}),
    ('sigmoid_focal', 'sigmoid_focal_loss', [_x(4, 6)],
     [np.round(_probs(4, 6, seed=2))], {}),
    ('sigmoid_focal_norm', 'sigmoid_focal_loss', [_x(4, 6)],
     [np.round(_probs(4, 6, seed=2)), np.array([3.0], np.float32)],
     {'reduction': 'mean', 'gamma': 1.5}),
    ('log_loss', 'log_loss', [_probs(5, 1)], [np.round(_probs(5, 1, 2))],
     {}),
    ('dice', 'dice_loss', [_soft(2, 3, 3, 4)], [_labels((2, 3, 3, 1), 4)],
     {}),
    ('npair', 'npair_loss', [_x(6, 4), _x(6, 4, seed=1)],
     [np.array([0, 1, 0, 2, 1, 3], np.int64)], {}),
]


@pytest.mark.parametrize('case,name,diff,const,kw', LOSSES,
                         ids=[c[0] for c in LOSSES])
def test_loss_matches_jax(case, name, diff, const, kw):
    _compare(lambda *a: getattr(JF, name)(*a, **kw),
             lambda *a: getattr(F, name)(*a, **kw), diff, const)


def test_cross_entropy_bf16_logits_match_jax():
    """bf16 logits: the loss in f32 arithmetic, the result and the
    gradient back in bf16, as the reference's custom backward gives."""
    x, lab = _x(16, 11), _labels((16,), 11, ignore=-100)
    want, jg = _jax_vjp(lambda v, y: JF.cross_entropy(v, y),
                        [jnp.asarray(x, jnp.bfloat16)], [lab])
    t = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    out = F.cross_entropy(t, torch.from_numpy(lab))
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(_cot((), 7))).backward()
    _close(_np(out), want, BF16_TOL, 'forward')
    _close(_np(t.grad), jg[0], BF16_TOL, 'gradient')
    assert t.grad.dtype == torch.bfloat16


def test_cross_entropy_under_o2_runs_in_f32():
    """``cross_entropy`` is black-listed: bf16 logits under O2 give the
    f32 loss of their f32 values, as the reference's."""
    x, lab = _x(8, 7), _labels((8,), 7)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    with paddle.amp.auto_cast(level='O2'):
        got = F.cross_entropy(xb, torch.from_numpy(lab))
    with jpaddle.amp.auto_cast(level='O2'):
        want = JF.cross_entropy(
            JaxTensor._from_value(jnp.asarray(x, jnp.bfloat16)),
            jpaddle.to_tensor(lab))
    assert got.dtype == torch.float32
    _close(_np(got), _np(want.value), TOL, 'O2 forward')


@pytest.mark.parametrize('with_weight', [False, True])
def test_bce_with_logits_pos_weight_matches_jax(with_weight):
    """``pos_weight`` takes the ``log_sigmoid`` form."""
    x, y = _x(4, 6), _probs(4, 6, seed=2)
    w = _probs(4, 6, seed=5) if with_weight else None
    pw = _probs(6, seed=6)

    def jfn(v, yy, pwv, *ww):
        return JF.binary_cross_entropy_with_logits(
            v, yy, ww[0] if ww else None, 'sum', pwv)

    def tfn(v, yy, pwv, *ww):
        return F.binary_cross_entropy_with_logits(
            v, yy, ww[0] if ww else None, 'sum', pwv)

    _compare(jfn, tfn, [x], [y, pw] + ([w] if with_weight else []))


@pytest.mark.parametrize('reduction', ['mean', 'sum', 'none'])
def test_ctc_loss_matches_jax(reduction):
    """Log-probabilities ``[T, B, C]``, labels of two lengths (a repeated
    label in one), input lengths short of T in one row."""
    T, B, C, S = 9, 3, 5, 4
    logits = _x(T, B, C)
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    labels = np.array([[1, 2, 2, 3], [4, 1, 0, 0], [3, 3, 1, 2]], np.int64)
    in_len = np.array([9, 7, 9], np.int64)
    lab_len = np.array([4, 2, 4], np.int64)
    _compare(lambda v, *c: JF.ctc_loss(v, *c, blank=0, reduction=reduction),
             lambda v, *c: F.ctc_loss(v, *c, blank=0, reduction=reduction),
             [lp.astype(np.float32)], [labels, in_len, lab_len])


@pytest.mark.parametrize('custom', [False, True])
def test_hsigmoid_loss_matches_jax(custom):
    """The default complete tree over 6 classes, and a custom tree from
    path tables (-1 padded)."""
    N, D, C = 5, 4, 6
    x, lab = _x(N, D), _labels((N, 1), C)
    if custom:
        table = np.array([[0, 1, -1], [0, 2, 3], [1, 4, -1], [0, 2, -1],
                          [3, 4, 5], [5, 1, -1]], np.int64)
        code = np.array([[1, 0, 0], [0, 1, 1], [1, 1, 0], [0, 0, 0],
                         [1, 0, 1], [0, 1, 0]], np.float32)
        w, b = _x(C, D, seed=2), _x(C, seed=3)
        kw = dict(path_table=table, path_code=code)
    else:
        w, b = _x(C - 1, D, seed=2), _x(C - 1, seed=3)
        kw = {}
    _compare(lambda v, ww, bb, y: JF.hsigmoid_loss(v, y, C, ww, bb, **kw),
             lambda v, ww, bb, y: F.hsigmoid_loss(v, y, C, ww, bb, **kw),
             [x, w, b], [lab])
    from paddle_tpu.nn.functional.loss import _hsigmoid_default_tree as jt
    from paddle_tpu_torch.nn.functional.loss import _hsigmoid_default_tree
    for a, b_ in zip(_hsigmoid_default_tree(11), jt(11)):
        assert np.array_equal(a, b_)


# (layer, constructor args, float inputs, constants)
LOSS_LAYERS = [
    ('CrossEntropyLoss', {'ignore_index': 1}, [_x(6, 5)],
     [_labels((6,), 5)]),
    ('BCELoss', {}, [_probs(4, 3)], [_probs(4, 3, seed=2)]),
    ('BCEWithLogitsLoss', {'reduction': 'sum'}, [_x(4, 3)],
     [_probs(4, 3, seed=2)]),
    ('MSELoss', {}, [_x(4, 3), _x(4, 3, seed=1)], []),
    ('L1Loss', {'reduction': 'none'}, [_x(4, 3), _x(4, 3, seed=1)], []),
    ('NLLLoss', {}, [_x(6, 5)], [_labels((6,), 5)]),
    ('KLDivLoss', {'reduction': 'sum'}, [_x(4, 5), _soft(4, 5)], []),
    ('SmoothL1Loss', {'delta': 0.5}, [_x(4, 3), _x(4, 3, seed=1)], []),
    ('MarginRankingLoss', {'margin': 0.2}, [_x(6), _x(6, seed=1)],
     [_pm1(6)]),
    ('HingeEmbeddingLoss', {'margin': 0.5}, [_x(6)], [_pm1(6)]),
    ('CosineEmbeddingLoss', {}, [_x(6, 4), _x(6, 4, seed=1)], [_pm1(6)]),
    ('SigmoidFocalLoss', {'alpha': 0.4}, [_x(4, 3)],
     [np.round(_probs(4, 3, seed=2))]),
]


@pytest.mark.parametrize('cls,kw,diff,const', LOSS_LAYERS,
                         ids=[c[0] for c in LOSS_LAYERS])
def test_loss_layer_matches_jax(cls, kw, diff, const):
    jl = getattr(jpaddle.nn, cls)(**kw)
    tl = getattr(nn, cls)(**kw)
    _compare(lambda *a: jl(*a), lambda *a: tl(*a), diff, const)


def test_ctc_and_hsigmoid_layers_match_jax():
    T, B, C = 6, 2, 4
    logits = _x(T, B, C)
    lp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(
        np.float32)
    consts = [np.array([[1, 2], [3, 0]], np.int64), np.array([6, 5]),
              np.array([2, 1])]
    _compare(lambda v, *c: jpaddle.nn.CTCLoss()(v, *c),
             lambda v, *c: nn.CTCLoss()(v, *c), [lp], consts)
    jl = jpaddle.nn.HSigmoidLoss(4, 6)
    tl = nn.HSigmoidLoss(4, 6)
    assert {k: tuple(v.shape) for k, v in tl.state_dict().items()} == {
        k: tuple(v.shape) for k, v in jl.state_dict().items()}
    tl.set_state_dict({k: np.asarray(v.value)
                       for k, v in jl.state_dict().items()})
    x, lab = _x(5, 4), _labels((5, 1), 6)
    _close(_np(tl(torch.from_numpy(x), torch.from_numpy(lab))),
           _np(jl(jpaddle.to_tensor(x), jpaddle.to_tensor(lab)).value), TOL,
           'HSigmoidLoss')


def test_every_reference_name_exists_in_the_port():
    import paddle_tpu.nn.functional.activation as ja
    import paddle_tpu.nn.functional.loss as jlf
    import paddle_tpu.nn.layer.activation as jla
    import paddle_tpu.nn.layer.loss as jll
    from paddle_tpu_torch.nn.functional import activation, loss
    from paddle_tpu_torch.nn.layer import activation as la, loss as ll
    for ref, port in ((ja, activation), (jlf, loss), (jla, la), (jll, ll)):
        missing = [n for n in ref.__all__ if not hasattr(port, n)]
        assert missing == [], f'{ref.__name__}: {missing}'
