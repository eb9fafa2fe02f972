"""The port's ``nn.Layer``, ``ParamAttr``, common layers, containers,
sequence functionals and tensor ops against the JAX package's, on the
CPU.

First the three signature faults the port had before this module's
layers were ported, each a case that failed there: the reference's
third positional argument of ``Embedding`` is ``padding_idx`` (the port
read it as its ``device``), and ``Linear(in, out, weight_attr,
bias_attr)`` and ``LayerNorm(shape, epsilon, weight_attr, bias_attr)``
take their attrs positionally (the port raised a ``TypeError``).

Forward results are held to the JAX package's within 2e-5 and
gradients within 1e-4 of the largest magnitude (f32, sums in another
order); selections and integer results exactly.
"""
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.nn import functional as JF
import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.initializer import Constant
from torch_seq_oracle import close, compare_vjp, jt, load_from_jax, np32

TOL, GRAD_TOL = 2e-5, 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device('cpu')
    yield
    paddle.set_device(None)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _keys(layer):
    return {k: tuple(v.shape) for k, v in layer.state_dict().items()}


# -- the three faults ---------------------------------------------------

def test_embedding_third_positional_argument_is_padding_idx():
    """``nn.Embedding(10, 4, 0)``: row 0 zeroed at construction, its
    lookups masked to zeros, so the row gets no gradient; the rest as
    the JAX package's."""
    pm = nn.Embedding(10, 4, 0, device='cpu')
    jpaddle.seed(0)
    jm = jpaddle.nn.Embedding(10, 4, 0)
    assert pm.padding_idx == 0 and pm.weight.device.type == 'cpu'
    assert float(pm.weight[0].detach().abs().max()) == 0.0
    load_from_jax(pm, jm)
    ids = np.array([[0, 3, 0], [9, 1, 3]], np.int64)
    compare_vjp(jm, pm, lambda m, i: m(i), [ids], TOL, GRAD_TOL)
    out = pm(torch.from_numpy(ids))
    assert float(out[0, 0].detach().abs().max()) == 0.0
    with torch.no_grad():
        pm.weight[0] = 1.0                     # a trained-into row stays
    out = pm(torch.from_numpy(ids))            # masked in the lookup
    pm.weight.grad = None
    out.sum().backward()
    assert float(out[0, 0].detach().abs().max()) == 0.0
    assert float(pm.weight.grad[0].abs().max()) == 0.0
    assert float(pm.weight.grad[3].abs().min()) == 2.0


def test_linear_takes_its_attrs_positionally():
    """``nn.Linear(4, 8, None, False)`` has no bias: its state dict holds
    ``weight`` only, as the reference's."""
    pm = nn.Linear(4, 8, None, False, device='cpu')
    jpaddle.seed(0)
    jm = jpaddle.nn.Linear(4, 8, None, False)
    assert pm.bias is None and _keys(pm) == _keys(jm) == {'weight': (4, 8)}
    compare_vjp(jm, load_from_jax(pm, jm), lambda m, a: m(a), [_x(3, 4)],
                TOL, GRAD_TOL)


def test_layer_norm_takes_its_attrs_positionally():
    """``nn.LayerNorm(8, 1e-5, None, False)``: weight only."""
    pm = nn.LayerNorm(8, 1e-5, None, False, device='cpu')
    jm = jpaddle.nn.LayerNorm(8, 1e-5, None, False)
    assert pm.bias is None and _keys(pm) == _keys(jm) == {'weight': (8,)}
    load_from_jax(pm, jm)
    with torch.no_grad():
        pm.weight.mul_(2.0)
    jm.weight.set_value(jnp.full((8,), 2.0))
    compare_vjp(jm, pm, lambda m, a: m(a), [_x(3, 8)], TOL, GRAD_TOL)
    wonly = nn.LayerNorm([8], 1e-6, False, None, device='cpu')
    assert _keys(wonly) == _keys(jpaddle.nn.LayerNorm([8], 1e-6, False))


def test_device_is_keyword_only_and_the_default_follows_set_device():
    assert nn.Linear(2, 3, device='cpu').weight.device.type == 'cpu'
    with pytest.raises(TypeError):
        nn.Linear(2, 3, None, None, None, 'cpu')
    assert paddle.get_device() == 'cpu'
    assert nn.Linear(2, 3).weight.device.type == 'cpu'
    paddle.set_device(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="set_device"):
            nn.Linear(2, 3)
    assert paddle.set_device('gpu:1') == torch.device('cuda', 1)
    paddle.set_device('cpu')


@pytest.mark.parametrize('padding_idx', [None, 2])
def test_functional_embedding_masks_padding_as_the_reference(padding_idx):
    w, ids = _x(6, 3), np.array([[2, 1], [5, 2]], np.int64)

    def run(f, wrap):
        return f(wrap(ids), wrap(w), padding_idx=padding_idx, sparse=True)
    want = np32(run(JF.embedding, jt))
    got = np32(run(F.embedding, torch.from_numpy))
    assert np.array_equal(got, want)


# -- Layer and ParamAttr -------------------------------------------------

def test_param_attr_initializer_trainable_and_learning_rate():
    """The attr's initializer draws the parameter, ``trainable=False``
    stops its gradient, and its ``learning_rate`` scales the eager
    step's rate, in both packages."""
    def build(pkg):
        return pkg.nn.Linear(
            3, 2, pkg.ParamAttr(initializer=pkg.nn.initializer.Constant(0.3),
                                learning_rate=0.5),
            pkg.ParamAttr(initializer=pkg.nn.initializer.Constant(-1.0),
                          trainable=False))
    pm, jm = build(paddle), build(jpaddle)
    assert np.array_equal(np32(pm.weight), np32(jm.weight))
    assert float(pm.weight[0, 0].detach()) == pytest.approx(0.3)
    assert float(pm.bias[0].detach()) == -1.0
    assert not pm.bias.requires_grad and jm.bias.stop_gradient
    assert pm.weight.optimize_attr == jm.weight.optimize_attr == {
        'learning_rate': 0.5}
    x = _x(4, 3)
    for pkg, m, wrap in ((paddle, pm, torch.from_numpy),
                         (jpaddle, jm, jpaddle.to_tensor)):
        opt = pkg.optimizer.SGD(0.1, parameters=m.parameters())
        m(wrap(x)).sum().backward()
        opt.step()
    # d sum / dW = x^T 1; the step is lr 0.1 times the attr's 0.5
    want = 0.3 - 0.05 * x.sum(0)[:, None] * np.ones((1, 2), np.float32)
    close(np32(pm.weight), want, 1e-6, 'port step')
    close(np32(jm.weight), want, 1e-6, 'JAX step')
    assert float(pm.bias[0].detach()) == -1.0


def test_param_attr_need_clip_leaves_a_parameter_out_of_the_clip():
    a = paddle.create_parameter([3], attr=paddle.ParamAttr(need_clip=False),
                                default_initializer=Constant(1.0))
    b = paddle.create_parameter([3], default_initializer=Constant(1.0))
    a.grad, b.grad = torch.full((3,), 10.0), torch.full((3,), 10.0)
    clip = nn.ClipGradByGlobalNorm(1.0)
    (_, ga), (_, gb) = clip([(a, a.grad), (b, b.grad)])
    assert torch.equal(ga, a.grad) and float(gb.norm()) == pytest.approx(1.0)


@pytest.mark.parametrize('build', [
    lambda p: p.nn.Linear(3, 4, bias_attr=False),
    lambda p: p.nn.LayerNorm(4, weight_attr=False),
    lambda p: p.nn.MultiHeadAttention(8, 2, bias_attr=False),
    lambda p: p.nn.TransformerEncoderLayer(8, 2, 16, bias_attr=False),
    lambda p: p.nn.BatchNorm1D(4, bias_attr=False),
    lambda p: p.nn.Embedding(5, 3, weight_attr=p.ParamAttr(
        initializer=p.nn.initializer.Constant(0.5))),
], ids=['linear', 'layer_norm', 'mha', 'encoder_layer', 'batch_norm',
        'embedding'])
def test_attr_false_leaves_a_parameter_out_of_both_state_dicts(build):
    assert _keys(build(paddle)) == _keys(build(jpaddle))


def test_batch_norm_takes_a_param_attr():
    bn = nn.BatchNorm2D(3, weight_attr=paddle.ParamAttr(
        initializer=Constant(2.0)), device='cpu')
    assert torch.equal(bn.weight.detach(), torch.full((3,), 2.0))
    assert _keys(bn) == _keys(jpaddle.nn.BatchNorm2D(3))


def _custom(pkg):
    nn_ = pkg.nn

    class Net(nn_.Layer):
        def __init__(self):
            super().__init__()
            self.w = self.create_parameter(
                [2, 3], default_initializer=nn_.initializer.Constant(1.0))
            self.add_parameter('extra', self.create_parameter(
                [3], is_bias=True))
            self.add_sublayer('head', nn_.Linear(2, 2))
            self.blocks = nn_.LayerList([nn_.Linear(2, 2) for _ in range(2)])
            self.table = nn_.LayerDict({'a': nn_.Linear(2, 1)})
            self.params = nn_.ParameterList([self.create_parameter([4])])
            self.register_buffer('kept', pkg.to_tensor(
                np.ones(2, np.float32)))
            self.register_buffer('scratch', pkg.to_tensor(
                np.zeros(2, np.float32)), persistable=False)

        def forward(self, x):
            return self.head(x @ self.w.T if pkg is paddle else
                             pkg.matmul(x, self.w, transpose_y=True))
    return Net()


def test_layer_api_matches_the_reference():
    pm, jm = _custom(paddle), _custom(jpaddle)
    assert _keys(pm) == _keys(jm)
    assert 'scratch' not in pm.state_dict() and 'kept' in pm.state_dict()
    assert [n for n, _ in pm.named_sublayers()] == [
        n for n, _ in jm.named_sublayers()]
    assert len(pm.sublayers(include_self=True)) == len(
        jm.sublayers(include_self=True))
    assert len(list(pm.parameters())) == len(jm.parameters())
    assert float(pm.extra.detach().abs().max()) == 0.0       # is_bias: 0
    missing, unexpected = pm.set_state_dict(
        {'w': np.full((2, 3), 3.0, np.float32), 'bogus': np.zeros(1)})
    assert 'head.weight' in missing and unexpected == ['bogus']
    assert float(pm.w[0, 0]) == 3.0
    with pytest.raises(ValueError, match='shape mismatch'):
        pm.set_state_dict({'w': np.zeros((3, 2), np.float32)})
    pm.eval()
    assert not any(m.training for m in pm.sublayers(include_self=True))
    pm.train()
    assert pm.head.training
    assert pm.full_name().startswith('net_')
    seen = []
    pm.register_forward_post_hook(lambda m, i, o: seen.append(o.shape))
    pm(torch.ones(5, 3)).sum().backward()
    assert seen == [(5, 2)] and pm.w.grad is not None
    pm.clear_gradients()
    assert pm.w.grad is None


def test_containers_match_the_reference():
    for pkg in (paddle, jpaddle):
        d = pkg.nn.LayerDict(collections.OrderedDict(
            [('x', pkg.nn.Linear(2, 2)), ('y', pkg.nn.Linear(2, 3))]))
        d['z'] = pkg.nn.Linear(3, 1)
        assert list(d.keys()) == ['x', 'y', 'z'] and len(d) == 3
        assert 'y' in d
        d.pop('y')
        d.update([('w', pkg.nn.Linear(1, 1))])
        assert list(d.keys()) == ['x', 'z', 'w']
        plist = pkg.nn.ParameterList([pkg.create_parameter([2], 'float32')])
        plist.append(pkg.create_parameter([3], 'float32'))
        assert len(plist) == 2 and tuple(plist[1].shape) == (3,)
    assert _keys(paddle.nn.LayerDict({'a': paddle.nn.Linear(2, 1)})) == \
        _keys(jpaddle.nn.LayerDict({'a': jpaddle.nn.Linear(2, 1)}))


def test_state_dict_keys_equal_the_jax_packages():
    for build in (lambda p: p.nn.Transformer(32, 4, 2, 2, 64),
                  lambda p: p.nn.Transformer(32, 4, 1, 1, 64,
                                             normalize_before=True,
                                             bias_attr=False),
                  lambda p: p.nn.LSTM(8, 16, 2, direction='bidirect'),
                  lambda p: p.nn.GRU(8, 16, time_major=True)):
        jpaddle.seed(0)
        want = {k: tuple(v.shape) for k, v in build(jpaddle).state_dict()
                .items()}
        assert {k: tuple(v.shape) for k, v in build(paddle).state_dict()
                .items()} == want


def test_one_set_of_numpy_arrays_loads_into_both_packages():
    """The port's Transformer and LSTM weights, taken to numpy, load into
    the JAX package's layers of the same signature (``set_state_dict``)
    and the other way (``convert.load_numpy_state``): the outputs
    agree."""
    from paddle_tpu_torch.convert import load_numpy_state
    x = _x(2, 5, 8)
    for build, fn in ((lambda p: p.nn.Transformer(8, 2, 1, 1, 16, 0.0),
                       lambda m, a: m(a, a)),
                      (lambda p: p.nn.LSTM(8, 6, 2, 'bidirect'),
                       lambda m, a: m(a)[0])):
        pm = build(paddle).eval()
        arrays = {k: v.numpy() for k, v in pm.state_dict().items()}
        jpaddle.seed(1)
        jm = build(jpaddle)
        jm.eval()
        jm.set_state_dict({k: jt(v) for k, v in arrays.items()})
        close(np32(fn(jm, jt(x))), np32(fn(pm, torch.from_numpy(x))), TOL,
              'port weights in the JAX layer')
        again = load_numpy_state(build(paddle).eval(), arrays)
        assert np.array_equal(np32(fn(again, torch.from_numpy(x))),
                              np32(fn(pm, torch.from_numpy(x))))


# -- common layers and functionals ---------------------------------------

@pytest.mark.parametrize('mode', ['constant', 'reflect', 'replicate',
                                  'circular'])
@pytest.mark.parametrize('cls,shape,pad,fmt', [
    ('Pad1D', (2, 3, 6), [1, 2], 'NCL'),
    ('Pad2D', (2, 3, 5, 6), [1, 2, 2, 1], 'NCHW'),
    ('Pad2D', (2, 5, 6, 3), [2, 1, 0, 2], 'NHWC'),
    ('Pad3D', (1, 2, 4, 5, 6), [1, 1, 2, 0, 1, 2], 'NCDHW')])
def test_pad_layers_match_jax(mode, cls, shape, pad, fmt):
    kw = dict(mode=mode, value=0.5, data_format=fmt)
    jm = getattr(jpaddle.nn, cls)(pad, **kw)
    pm = getattr(nn, cls)(pad, **kw)
    compare_vjp(jm, pm, lambda m, a: m(a), [_x(*shape)], TOL, GRAD_TOL)


def test_pad_flat_and_int_forms_match_jax():
    x = _x(2, 3, 4)
    for pad in ([0, 0, 1, 2, 2, 1], 1):
        want = np32(JF.pad(jt(x), pad, mode='constant', value=-1.0))
        got = np32(F.pad(torch.from_numpy(x), pad, value=-1.0))
        assert np.array_equal(got, want)


def test_identity_flatten_and_cosine_similarity_match_jax():
    x = _x(2, 3, 4)
    assert torch.equal(nn.Identity(7, a=1)(torch.from_numpy(x)),
                       torch.from_numpy(x))
    for args in ((), (0, 1)):
        want = np32(jpaddle.nn.Flatten(*args)(jt(x)))
        assert np.array_equal(np32(nn.Flatten(*args)(torch.from_numpy(x))),
                              want)
    jm, pm = jpaddle.nn.CosineSimilarity(2), nn.CosineSimilarity(2)
    compare_vjp(jm, pm, lambda m, a, b: m(a, b),
                [x, _x(2, 3, 4, seed=1)], TOL, GRAD_TOL)


@pytest.mark.parametrize('p,axis', [(2, 1), (1, -1), (3, 0)])
def test_normalize_matches_jax(p, axis):
    compare_vjp(jpaddle.nn.Identity(), nn.Identity(),
                lambda m, a: (JF if isinstance(a, type(jt(1))) else F)
                .normalize(a, p=p, axis=axis), [_x(3, 4)], TOL, GRAD_TOL)


@pytest.mark.parametrize('prior', [False, True])
def test_label_smooth_matches_jax(prior):
    lab = np.eye(5, dtype=np.float32)[[0, 3, 4, 1]]
    pd = _x(5, seed=3) ** 2 if prior else None
    want = np32(JF.label_smooth(jt(lab), None if pd is None else jt(pd),
                                epsilon=0.2))
    got = np32(F.label_smooth(torch.from_numpy(lab), None if pd is None else
                              torch.from_numpy(pd), epsilon=0.2))
    close(got, want, TOL, 'label_smooth')


def test_one_hot_and_sequence_mask_match_jax():
    ids = np.array([[0, 4], [2, 7]], np.int64)      # 7: out of range
    want = np32(JF.one_hot(jt(ids), 5))
    got = F.one_hot(torch.from_numpy(ids), 5)
    assert got.dtype == torch.float32 and np.array_equal(np32(got), want)
    lens = np.array([1, 3, 0], np.int64)
    for maxlen in (None, 5):
        want = np32(JF.sequence_mask(jt(lens), maxlen))
        got = F.sequence_mask(torch.from_numpy(lens), maxlen)
        assert got.dtype == torch.int64 and np.array_equal(np32(got), want)
    assert F.sequence_mask(torch.from_numpy(lens), 4,
                           dtype='float32').dtype == torch.float32


@pytest.mark.parametrize('fn,fmt,shape,axes', [
    ('dropout2d', 'NCHW', (3, 4, 5, 6), (0, 1)),
    ('dropout2d', 'NHWC', (3, 5, 6, 4), (0, 3)),
    ('dropout3d', 'NCDHW', (2, 4, 3, 5, 6), (0, 1))])
def test_channel_dropouts_drop_whole_channels(fn, fmt, shape, axes):
    paddle.seed(0)
    x = torch.ones(shape)
    y = getattr(F, fn)(x, 0.5, training=True, data_format=fmt)
    kept = y != 0
    other = tuple(i for i in range(len(shape)) if i not in axes)
    assert torch.equal(kept.all(dim=other), kept.any(dim=other))
    assert set(torch.unique(y).tolist()) <= {0.0, 2.0}
    assert torch.equal(getattr(F, fn)(x, 0.5, training=False,
                                      data_format=fmt), x)
    layer = getattr(nn, fn.replace('dropout', 'Dropout').upper()
                    .replace('DROPOUT', 'Dropout'))(0.5, fmt)
    assert torch.equal(layer.eval()(x), x)


def test_alpha_dropout_keeps_selu_statistics():
    """A dropped element becomes ``a * (-alpha * scale) + b`` and a kept
    one ``a * x + b`` with the reference's ``a`` and ``b``, in both
    packages, about ``p`` of them dropped; mean and variance stay near 0
    and 1; eval is the identity."""
    p = 0.2
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = 1.0 / np.sqrt((1.0 - p) * (1.0 + p * alpha_p ** 2))
    b = -a * alpha_p * p
    paddle.seed(0)
    x = torch.randn(200000)
    ys = [np32(F.alpha_dropout(x, p, training=True)),
          np32(JF.alpha_dropout(jt(x.numpy()), p, training=True))]
    for y in ys:
        kept = np.isclose(y, a * x.numpy() + b, rtol=0, atol=1e-5)
        dropped = np.isclose(y, a * alpha_p + b, rtol=0, atol=1e-5)
        assert (kept | dropped).all()
        assert abs(float(dropped.mean()) - p) < 0.01
        assert abs(float(y.mean())) < 0.02 and abs(float(y.var()) - 1) < 0.03
    layer = nn.AlphaDropout(p)
    assert torch.equal(layer.eval()(x), x)


# -- tensor ops -----------------------------------------------------------

TENSOR_OPS = [
    ('expand', lambda p, a: p.expand(a, [3, 2, 4]), (1, 2, 4)),
    ('unsqueeze', lambda p, a: p.unsqueeze(a, [0, 2]), (2, 3)),
    ('squeeze', lambda p, a: p.squeeze(a, [1, 2]), (2, 1, 3)),
    ('squeeze_all', lambda p, a: p.squeeze(a), (2, 1, 3, 1)),
    ('transpose', lambda p, a: p.transpose(a, [2, 0, 1]), (2, 3, 4)),
    ('flip', lambda p, a: p.flip(a, [0, 2]), (2, 3, 4)),
    ('tile', lambda p, a: p.tile(a, [2, 1, 3]), (2, 3, 1)),
    ('gather', lambda p, a: p.gather(a, p.to_tensor(np.array([2, 0])), 1),
     (2, 3, 4)),
    ('gather_nd', lambda p, a: p.gather_nd(a, p.to_tensor(
        np.array([[0, 1], [1, 2]]))), (2, 3, 4)),
    ('matmul', lambda p, a: p.matmul(a, a, transpose_y=True), (2, 3, 4)),
    ('matmul_tx', lambda p, a: p.matmul(a, a, transpose_x=True), (3, 4)),
    ('mean', lambda p, a: p.mean(a, axis=[0, 2]), (2, 3, 4)),
    ('scale', lambda p, a: p.scale(a, 2.5, 1.0), (2, 3)),
    ('where', lambda p, a: p.where(p.greater_than(a, p.zeros_like(a))
                                   if p is jpaddle else a > 0, a,
                                   p.zeros_like(a)), (3, 4)),
    ('concat', lambda p, a: p.concat([a, a * 2], axis=1), (2, 3)),
]


@pytest.mark.parametrize('name,fn,shape', TENSOR_OPS,
                         ids=[n for n, _, _ in TENSOR_OPS])
def test_tensor_op_matches_jax(name, fn, shape):
    compare_vjp(jpaddle.nn.Identity(), nn.Identity(),
                lambda m, a: fn(paddle if isinstance(a, torch.Tensor)
                                else jpaddle, a), [_x(*shape)], TOL,
                GRAD_TOL)


def test_split_unbind_topk_argmax_and_logic_match_jax():
    x = _x(6, 5)
    tx, jx = torch.from_numpy(x), jt(x)
    for sections in (3, [1, -1, 2]):
        for a, b in zip(paddle.split(tx, sections, axis=0),
                        jpaddle.split(jx, sections, axis=0)):
            assert np.array_equal(np32(a), np32(b))
    for a, b in zip(paddle.unbind(tx, 1), jpaddle.unbind(jx, 1)):
        assert np.array_equal(np32(a), np32(b))
    for largest in (True, False):
        tv, ti = paddle.topk(tx, 3, axis=1, largest=largest)
        jv, ji = jpaddle.topk(jx, 3, axis=1, largest=largest)
        assert np.array_equal(np32(tv), np32(jv))
        assert np.array_equal(ti.numpy(), np32(ji).astype(np.int64))
    assert np.array_equal(paddle.argmax(tx, axis=1).numpy(),
                          np32(jpaddle.argmax(jx, axis=1)))
    a, b = np.array([1, 2, 3]), np.array([1, 0, 3])
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for op in ('equal', 'not_equal'):
        assert np.array_equal(getattr(paddle, op)(ta, tb).numpy(),
                              np32(getattr(jpaddle, op)(jt(a), jt(b))))
    ba, bb = ta > 1, tb > 1
    for op in ('logical_and', 'logical_or', 'logical_xor'):
        assert np.array_equal(
            getattr(paddle, op)(ba, bb).numpy(),
            np32(getattr(jpaddle, op)(jt(a > 1), jt(b > 1))).astype(bool))
    assert paddle.logical_not(ba).tolist() == [True, False, False]
    assert not bool(paddle.all(ba)) and bool(paddle.all(ba | ~ba))


def test_creation_ops_match_jax():
    for name, args in (('zeros', ([2, 3],)), ('ones', ([2, 3], 'int64')),
                       ('full', ([2, 2], 7)), ('arange', (1, 7, 2))):
        got = getattr(paddle, name)(*args)
        want = np32(getattr(jpaddle, name)(*args))
        assert got.device.type == 'cpu'
        assert np.array_equal(np32(got), want), name
    assert paddle.full([1], 3).dtype == torch.float32       # as the reference
    x = torch.ones(2, 3, dtype=torch.float64)
    assert paddle.zeros_like(x).dtype == torch.float64
    assert float(paddle.full_like(x, 4).sum()) == 24.0
    t = paddle.to_tensor(np.arange(3), stop_gradient=False, dtype='float32')
    assert t.requires_grad and t.dtype == torch.float32
    assert paddle.to_tensor([1.5]).dtype == torch.float32


def test_the_names_the_reference_seq2seq_test_uses_are_top_level():
    for name in ('to_tensor', 'concat', 'expand', 'seed', 'optimizer', 'nn',
                 'ParamAttr', 'set_device', 'zeros', 'matmul'):
        assert hasattr(paddle, name), name
    for name in ('Layer', 'ParamAttr', 'Transformer', 'LSTM', 'GRU',
                 'SimpleRNN', 'BeamSearchDecoder', 'dynamic_decode',
                 'ParameterList', 'LayerDict', 'Dropout2D', 'Dropout3D',
                 'AlphaDropout', 'Flatten', 'Pad1D', 'Pad2D', 'Pad3D',
                 'Identity', 'CosineSimilarity'):
        assert hasattr(nn, name), name


def test_every_reference_name_of_these_modules_exists_in_the_port():
    import paddle_tpu.nn.layer.container as jc
    from paddle_tpu_torch.nn.layer import container
    assert [n for n in jc.__all__ if not hasattr(container, n)] == []
