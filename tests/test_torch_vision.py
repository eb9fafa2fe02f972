"""The port's LeNet and ResNets against the JAX package's, on the CPU.

Each JAX model is built from a seed; its parameters and BatchNorm
buffers (``functional_state()``) go to numpy and load into the port's
model (``load_numpy_state``).  The gradient oracle is ``jax.grad`` of
the JAX model's training forward (``functional_call``, which also
returns the updated buffers) and ``CrossEntropyLoss``; the trainer
oracle is the JAX ``ParallelTrainer`` with ``Momentum``.

The oracle runs op by op, not under ``jax.jit``: jitted on the CPU,
XLA fuses ``x * scale + shift`` into a fused multiply-add in the forward
but not where the backward recomputes the ReLU mask, so an element next
to 0 can take one side forward and the other backward; the jitted
ResNet-18 gradient then lies up to 14% of a tensor's largest value from
an exact float64 run, the op-by-op one 6e-6.  The images are 64 x 64
(the issue's 32 x 32 leaves ResNet's last stage 1 x 1, where BatchNorm
of 2 values a channel turns rounding into sign flips).

Tolerances, f32: logits and losses 1e-5; every gradient and BatchNorm
buffer within 1e-3 of its tensor's largest value.  ResNet-50's and the
bf16 tests' bounds are in their docstrings.  The JAX ResNets and
ResNet-50's train-mode oracle are built once for the module (the
fixtures below): the JAX package's op-by-op dispatch compiles every
primitive at its first shape, which is most of this file's time.
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
from paddle_tpu.jit import functional_call
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import Momentum as JaxMomentum
from paddle_tpu.parallel import ParallelTrainer as JaxTrainer
from paddle_tpu.vision import models as jax_models
from paddle_tpu_torch import amp, nn
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.parallel import ParallelTrainer
from paddle_tpu_torch.vision import models


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """torch's intra-op threads at 2 for this module, restored after:
    the suite runs six workers on the machine's cores, and torch's
    default of a thread a core oversubscribes them."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

TOL, REL = 1e-5, 1e-3
# ResNet-50's train-mode gradient is held as one vector (see
# test_resnet50_train_gradient_is_ill_conditioned_in_f32); NUDGE is the
# relative move of the images that shows why
GRAD_NORM_REL, NUDGE = 5e-2, 1e-7


def _auto_cast(level, package=amp):
    """``package.auto_cast(level)``, or nothing without a level."""
    return package.auto_cast(level=level) if level else \
        contextlib.nullcontext()


def _numpy_state(jm):
    params, buffers = jm.functional_state()
    return ({k: np.array(v) for k, v in params.items()},
            {k: np.array(v) for k, v in buffers.items()})


def _jax_model(name, seed=0, **kw):
    paddle.seed(seed)
    return getattr(jax_models, name)(**kw)


def _port_model(name, state, **kw):
    return getattr(models, name)(device='cpu', **kw).load_numpy_state(*state)


def _batch(shape, classes, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    y = rs.randint(0, classes, (shape[0], 1)).astype(np.int64)
    return x, y


def _nudged(x):
    """``x`` moved by NUDGE of its values (seeded), kept in its dtype:
    in f32 a move of an ulp or so, the size of f32's own rounding."""
    return (x * (1 + NUDGE * np.random.RandomState(5).randn(*x.shape))
            ).astype(x.dtype)


def _rel_close(got, want, rel, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max()) / scale
    assert err <= rel, f'{what}: max |diff| / max |want| {err:.3e} > {rel}'


def _flat(grads, names):
    return np.concatenate([np.asarray(grads[n], np.float64).ravel()
                           for n in names])


def _norm_rel(got, want):
    """|got - want| / |want|, each dict of gradients as one vector."""
    names = sorted(want)
    w = _flat(want, names)
    return np.linalg.norm(_flat(got, names) - w) / np.linalg.norm(w)


def _jax_loss_grads(jm, x, y, level=None, training=True):
    """jax.value_and_grad of CE(model(x), y) in training mode, op by
    op (not jitted: see the module docstring): (loss, grads, the buffers
    after the forward)."""
    params, buffers = jm.functional_state()

    def loss_of(p):
        # the loss under the forward's policy, as both trainers run it
        with _auto_cast(level, paddle.amp):
            out, new = functional_call(jm, p, buffers, (jnp.asarray(x),),
                                       training=training)
            with jax_no_grad():
                loss = JF.cross_entropy(
                    JaxTensor._from_value(out),
                    JaxTensor._from_value(jnp.asarray(y)))
        return loss.value.astype(jnp.float32).mean(), new

    (loss, new), grads = jax.value_and_grad(loss_of, has_aux=True)(params)
    return (float(loss), {k: np.asarray(v, np.float32)
                          for k, v in grads.items()},
            {k: np.asarray(v) for k, v in new.items()})


def _port_loss_grads(pm, x, y, level=None, training=True):
    pm.train(training)
    with _auto_cast(level):
        loss = F.cross_entropy(pm(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    return (float(loss.detach()), {n: p.grad.float().numpy()
                          for n, p in pm.named_parameters()},
            {n: b.numpy() for n, b in pm.named_buffers()})


def _exact_batch_norm(x, running_mean, running_var, weight=None,
                      bias=None, training=False, momentum=0.9,
                      epsilon=1e-5, data_format='NCHW',
                      use_global_stats=None, name=None, group=None):
    """The float64 witness's BatchNorm: batch statistics in the input's
    own dtype, two-pass (the port's, as the reference's, takes any
    input that is not f32 to f32 one-pass statistics); the running
    statistics stay as they are.  One process: ``group`` is None."""
    ch = x.dim() - 1 if data_format in ('NHWC', 'NLC', 'NDHWC') else 1
    red = tuple(i for i in range(x.dim()) if i != ch)
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    scale = weight / torch.sqrt(x.var(dim=red, correction=0) + epsilon)
    shift = bias - x.mean(dim=red) * scale
    return x * scale.reshape(shape) + shift.reshape(shape)


def _exact_grads(name, state, x, y, monkeypatch, **kw):
    """The train-mode gradient of the port's model taken to float64,
    with float64 batch statistics: the exact run that f32 runs are
    judged against."""
    pm = _port_model(name, state, **kw).double()
    with monkeypatch.context() as m:
        m.setattr(F, 'batch_norm', _exact_batch_norm)
        loss = F.cross_entropy(pm.train()(torch.from_numpy(x).double()),
                               torch.from_numpy(y))
        loss.backward()
    return {n: p.grad.numpy() for n, p in pm.named_parameters()}


@pytest.fixture(scope='module')
def r18():
    """The JAX resnet18 (10 classes, NCHW, seed 0) and its numpy state."""
    jm = _jax_model('resnet18', num_classes=10)
    return jm, _numpy_state(jm)


@pytest.fixture(scope='module')
def r50():
    """The JAX resnet50 (10 classes, NHWC, seed 0), its numpy state, a
    B 2 x 64 x 64 batch and ``jax.grad`` in train mode on it."""
    jm = _jax_model('resnet50', num_classes=10, data_format='NHWC')
    x, y = _batch((2, 64, 64, 3), 10)
    return jm, _numpy_state(jm), (x, y), _jax_loss_grads(jm, x, y)


# (model, constructor kwargs, input shape)
MODELS = [
    ('LeNet', {}, (2, 1, 28, 28)),
    ('resnet18', dict(num_classes=10), (4, 3, 64, 64)),
]


@pytest.mark.parametrize('name,kw,shape', MODELS, ids=[m[0] for m in MODELS])
def test_loss_gradients_and_buffers_match_jax_grad(name, kw, shape, request):
    if name == 'resnet18':
        jm, state = request.getfixturevalue('r18')
    else:
        jm = _jax_model(name, **kw)
        state = _numpy_state(jm)
    pm = _port_model(name, state, **kw)
    assert set(dict(pm.named_parameters())) == set(state[0])
    assert set(dict(pm.named_buffers())) == set(state[1])
    x, y = _batch(shape, 10)
    want_loss, want_g, want_b = _jax_loss_grads(jm, x, y)
    loss, grads, bufs = _port_loss_grads(pm, x, y)
    np.testing.assert_allclose(loss, want_loss, rtol=TOL, atol=TOL)
    for n, g in want_g.items():
        _rel_close(grads[n], g, REL, n)
    for n, b in want_b.items():
        _rel_close(bufs[n], b, REL, n)


def test_resnet50_matches_jax_in_eval_and_train_modes(r50):
    """ResNet-50 (NHWC, B 2, 64 x 64).  On running statistics the loss
    and every gradient agree within 1e-5 and 1e-3 of its tensor's
    largest value (measured 3e-6).  On batch statistics the loss within
    1e-4, the updated buffers as above, and the gradient as one vector
    within GRAD_NORM_REL of its norm (measured 2.1e-2): layer4
    normalises 8 values a channel here and the f32 train-mode gradient
    is ill-conditioned (the next test is the witness)."""
    jm, state, (x, y), (want_loss, want_g, want_b) = r50
    kw = dict(num_classes=10, data_format='NHWC')
    loss, grads, bufs = _port_loss_grads(_port_model('resnet50', state, **kw),
                                         x, y)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-4)
    for n, b in want_b.items():
        _rel_close(bufs[n], b, REL, n)
    assert _norm_rel(grads, want_g) <= GRAD_NORM_REL
    want_loss, want_g, _ = _jax_loss_grads(jm, x, y, training=False)
    loss, grads, _ = _port_loss_grads(_port_model('resnet50', state, **kw),
                                      x, y, training=False)
    np.testing.assert_allclose(loss, want_loss, rtol=TOL)
    for n, g in want_g.items():
        _rel_close(grads[n], g, REL, n)


def test_resnet50_train_gradient_is_ill_conditioned_in_f32(r50, r18,
                                                           monkeypatch):
    """The float64 witness of the bound above.  Against an exact run
    (the port's model in float64 with float64 batch statistics), the
    port's and the JAX package's f32 train-mode gradients each lie
    within GRAD_NORM_REL of its norm (measured 1.9e-2 and 1.5e-2, up to
    0.19 of a tensor's largest value), and the exact gradient itself
    moves by more than 3e-3 of its norm (measured 7.0e-3, up to 6e-2 of
    a tensor's largest value) when the images move by NUDGE of their
    values, less than f32's rounding of them: no f32 run can hold each
    tensor to 1e-3.  ResNet-18 at its test batch moves by less than 1e-5
    (measured 6e-7), and its gradients are held per tensor; a nudge
    nearer its own rounding can still tip a ReLU input that lies within
    it of 0 (the smoke's ``resnet_parity`` bounds that on the card)."""
    jm, state, (x, y), (_, jax_g, _) = r50
    kw = dict(num_classes=10, data_format='NHWC')
    exact = _exact_grads('resnet50', state, x, y, monkeypatch, **kw)
    _, port_g, _ = _port_loss_grads(_port_model('resnet50', state, **kw),
                                    x, y)
    assert _norm_rel(port_g, exact) <= GRAD_NORM_REL
    assert _norm_rel(jax_g, exact) <= GRAD_NORM_REL
    nudged = _exact_grads('resnet50', state, _nudged(x), y, monkeypatch,
                          **kw)
    assert _norm_rel(nudged, exact) > 3e-3
    x18, y18 = _batch((4, 3, 64, 64), 10)
    exact18 = _exact_grads('resnet18', r18[1], x18, y18, monkeypatch,
                           num_classes=10)
    nudged18 = _exact_grads('resnet18', r18[1], _nudged(x18), y18,
                            monkeypatch, num_classes=10)
    assert _norm_rel(nudged18, exact18) < 1e-5


def test_resnet18_under_o2_matches_jax():
    """bf16 O2 (NHWC, B 4, 64 x 64): the loss within 2e-3 relative, the
    buffers within 2e-2 of each tensor's largest value (a few bf16 steps:
    the update runs in bf16), and the gradient as one vector within 0.3
    of its norm, nearer the reference's bf16 gradient than either is to
    the f32 one (each lies 0.40 of the norm from it, the two 0.22
    apart), and no farther from it than 1.5 times the port's own bf16
    gradient moves when the f32 images move by NUDGE of their values.
    That control moves 0.21 of the norm (the reference's own, 0.22): the
    nudge changes only how some images round to bf16, so the gap between
    the two packages is bf16 rounding, which the backward through
    BatchNorm's batch statistics amplifies in either."""
    kw = dict(num_classes=10, data_format='NHWC')
    jm = _jax_model('resnet18', **kw)
    state = _numpy_state(jm)
    pm = _port_model('resnet18', state, **kw)
    x, y = _batch((4, 64, 64, 3), 10)
    want_loss, want_g, want_b = _jax_loss_grads(jm, x, y, level='O2')
    loss, grads, bufs = _port_loss_grads(pm, x, y, level='O2')
    np.testing.assert_allclose(loss, want_loss, rtol=2e-3)
    for n, b in want_b.items():
        _rel_close(bufs[n], b, 2e-2, n)
    _, f32_g, _ = _port_loss_grads(_port_model('resnet18', state, **kw), x,
                                   y)
    _, nudged_g, _ = _port_loss_grads(_port_model('resnet18', state, **kw),
                                      _nudged(x), y, level='O2')
    names = sorted(want_g)
    got, want, f32, nudged = (_flat(d, names)
                              for d in (grads, want_g, f32_g, nudged_g))
    apart = np.linalg.norm(got - want)
    assert apart <= 0.3 * np.linalg.norm(want)
    assert apart < min(np.linalg.norm(got - f32), np.linalg.norm(want - f32))
    assert apart <= 1.5 * np.linalg.norm(nudged - got)


def test_state_keys_and_shapes_are_the_jax_models(r50):
    params, buffers = r50[1]
    pm = models.resnet50(device='cpu', num_classes=10, data_format='NHWC')
    got = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert got == {k: v.shape for k, v in {**params, **buffers}.items()}
    assert sum(1 for k in got if k.endswith('._mean')) == 53
    assert len(list(pm.buffers())) == 106


def test_nhwc_is_nchw_and_the_s2d_stem_is_the_7x7_stem(r18):
    """One set of weights (OIHW either way) in NCHW, NHWC and NHWC with
    the space-to-depth stem (its 4x4 weight re-laid from the 7x7 one by
    ``space_to_depth_stem_weight``, the JAX package's function
    reproduced): the same logits."""
    params, buffers = r18[1]
    x, _ = _batch((4, 3, 64, 64), 10)
    nchw = _port_model('resnet18', (params, buffers), num_classes=10)
    nhwc = _port_model('resnet18', (params, buffers), num_classes=10,
                       data_format='NHWC')
    w4 = models.space_to_depth_stem_weight(params['conv1.weight'])
    np.testing.assert_array_equal(
        w4, jax_models.resnet.space_to_depth_stem_weight(
            params['conv1.weight']))
    s2d = _port_model('resnet18', (dict(params, **{'conv1.weight': w4}),
                                   buffers),
                      num_classes=10, data_format='NHWC',
                      stem_space_to_depth=True)
    xt = torch.from_numpy(x)
    xl = xt.permute(0, 2, 3, 1).contiguous()
    with torch.no_grad():
        want = nchw.train()(xt)
        for other in (nhwc, s2d):
            _rel_close(other.train()(xl).numpy(), want.numpy(), TOL,
                       'logits')
    for a, b in zip(nchw.buffers(), s2d.buffers()):
        _rel_close(b.numpy(), a.numpy(), TOL, 'buffer')
    with pytest.raises(ValueError, match='NHWC'):
        models.resnet18(device='cpu', stem_space_to_depth=True)
    odd = models.resnet18(device='cpu', data_format='NHWC',
                          stem_space_to_depth=True)
    with pytest.raises(ValueError, match='even'):
        odd(torch.zeros(1, 31, 32, 3))
    with pytest.raises(NotImplementedError):
        models.resnet50(pretrained=True)


def test_headless_and_poolless_resnet_and_lenet():
    jm = _jax_model('resnet18', num_classes=0, with_pool=False)
    pm = _port_model('resnet18', _numpy_state(jm), num_classes=0,
                     with_pool=False)
    x, _ = _batch((2, 3, 64, 64), 10)
    with jax_no_grad():
        jm.eval()
        want = np.asarray(jm(paddle.to_tensor(x)).value)
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 512, 2, 2)
    _rel_close(got, want, TOL, 'features')
    assert models.LeNet(num_classes=0, device='cpu')(
        torch.zeros(1, 1, 28, 28)).shape == (1, 16, 5, 5)


def _trainers(jm, state, lr=0.01, steps=3):
    """The JAX ParallelTrainer's step (``_raw_step``, a function of the
    state it is handed, run op by op: see the module docstring) and the
    port's ParallelTrainer, Momentum 0.9, f32, over ``steps`` seeded
    batches of resnet18 at B 4, both from ``jm``'s ``state``."""
    pm = _port_model('resnet18', state, num_classes=10)
    jce, pce = paddle.nn.CrossEntropyLoss(), nn.CrossEntropyLoss()
    jt = JaxTrainer(jm, JaxMomentum(learning_rate=lr, momentum=0.9,
                                    parameters=jm.parameters()),
                    lambda out, y: jce(out, y))
    jt._build_step()
    pt = ParallelTrainer(pm, Momentum(learning_rate=lr, momentum=0.9,
                                      parameters=pm.parameters()),
                         lambda out, y: pce(out, y))
    losses = []
    for i in range(steps):
        x, y = _batch((4, 3, 64, 64), 10, seed=i)
        jt.params, jt.buffers, jt.opt_state, loss = jt._raw_step(
            jt.params, jt.buffers, jt.opt_state, jnp.asarray(i + 1),
            jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y))
        losses.append((float(loss), float(pt.step(x, y))))
    return jt, pt, losses


def test_three_momentum_steps_match_the_jax_trainer(r18):
    """Losses and BatchNorm buffers within 1e-5 and 1e-4 of the JAX
    trainer's; parameters within 1e-3 absolute (a tenth of a step of
    lr 0.01 with a unit gradient).  The f32 trajectory's own rounding
    reaches 5e-4: at step 3 a ReLU input of layer3 sits close enough to 0
    that f32 rounding decides its side, and that step's gradient of
    ``layer3.1.conv2.weight`` moves by a third between the port in f32
    and in f64 while the loss agrees to 1e-6; relative to a bias's own
    small values that is up to 1e-2.  So the port run in float64 from
    the same weights is also held to the JAX f32 trajectory within 1e-5
    of each tensor's largest value: the same computation."""
    jm, state = r18
    jt, pt, losses = _trainers(jm, state)
    for want, got in losses:
        np.testing.assert_allclose(got, want, rtol=TOL)
    got = dict(pt.model.named_parameters())
    for n, v in jt.params.items():
        np.testing.assert_allclose(got[n].detach().numpy(), np.asarray(v),
                                   rtol=0, atol=1e-3, err_msg=n)
    bufs = dict(pt.model.named_buffers())
    assert set(bufs) == set(jt.buffers)
    for n, v in jt.buffers.items():
        _rel_close(bufs[n].numpy(), np.asarray(v), 1e-4, n)
    pm = _port_model('resnet18', state, num_classes=10).double()
    ce = nn.CrossEntropyLoss()
    tr = ParallelTrainer(pm, Momentum(learning_rate=0.01, momentum=0.9,
                                      parameters=pm.parameters()),
                         lambda out, y: ce(out, y))
    for i in range(3):
        x, y = _batch((4, 3, 64, 64), 10, seed=i)
        tr.step(x.astype(np.float64), y)
    got = dict(pm.named_parameters())
    for n, v in jt.params.items():
        _rel_close(got[n].detach().numpy(), np.asarray(v), TOL, n)


def _port_trainer(fused_steps=None, nan_guard=False, seed=0):
    pm = models.resnet18(device='cpu', num_classes=10, seed=seed)
    ce = nn.CrossEntropyLoss()
    st = DistributedStrategy()
    st.amp = True
    st.amp_configs['use_pure_fp16'] = True
    return ParallelTrainer(pm, Momentum(learning_rate=0.05, momentum=0.9,
                                        parameters=pm.parameters()),
                           lambda out, y: ce(out, y), strategy=st,
                           fused_steps=fused_steps, nan_guard=nan_guard)


def _state(trainer):
    return {k: v.detach().clone() for k, v in
            trainer.model.state_dict().items()}


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_step_fused_equals_eager_steps_buffers_included():
    """bf16 O2 resnet18: one ``step_fused`` chunk of K 3 (on the CPU the
    graph cache hands out the step itself) against 3 ``step`` calls:
    the losses, every parameter and every BatchNorm buffer equal."""
    k = 3
    batches = [_batch((4, 3, 64, 64), 10, seed=i) for i in range(k)]
    eager = _port_trainer()
    losses = torch.stack([eager.step(*b) for b in batches])
    fused = _port_trainer(fused_steps=k)
    chunk = tuple(np.stack(col) for col in zip(*batches))
    got = fused.step_fused(*chunk)
    assert torch.equal(got, losses)
    assert fused._step_no == eager._step_no == k
    _equal(_state(fused), _state(eager))
    assert not torch.equal(fused.model.bn1._mean, torch.zeros(64))


def test_nan_guard_keeps_the_buffers_through_a_poisoned_step():
    """A NaN pixel: the step's loss is NaN and its update is dropped,
    BatchNorm's running statistics included, eager and in a guarded
    chunk; the next finite step trains on."""
    x, y = _batch((4, 3, 64, 64), 10)
    bad = x.copy()
    bad[0, 0, 3, 3] = np.nan
    tr = _port_trainer(nan_guard=True)
    tr.step(x, y)
    before = _state(tr)
    assert not np.isfinite(float(tr.step(bad, y)))
    _equal(_state(tr), before)
    assert tr._step_no == 1 and tr.sentinel.total_skipped == 1
    tr.step(x, y)
    assert not torch.equal(tr.model.bn1._mean, before['bn1._mean'])

    guarded = _port_trainer(fused_steps=3, nan_guard=True)
    plain = _port_trainer(nan_guard=True)
    for b in (x, x):
        plain.step(b, y)
    losses = guarded.step_fused(np.stack([x, bad, x]), np.stack([y, y, y]))
    assert not np.isfinite(float(losses[1]))
    assert guarded._step_no == 2
    _equal(_state(guarded), _state(plain))


def test_eval_step_reads_the_running_statistics():
    tr = _port_trainer()
    x, y = _batch((4, 3, 64, 64), 10)
    tr.step(x, y)
    before = _state(tr)
    out, loss = tr.eval_step(x, y)
    _equal(_state(tr), before)
    assert out.shape == (4, 10) and out.dtype == torch.float32
    with torch.no_grad():
        want = tr.model.eval()(torch.from_numpy(x))
    assert torch.equal(out, want)
    assert torch.isfinite(loss)
