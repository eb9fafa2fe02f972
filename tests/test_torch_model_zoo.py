"""The rest of the port's model zoo against the JAX package's, on the CPU:
ERNIE and VGG (MobileNet v1/v2 are in ``test_torch_mobilenet.py``), and
the container and shape ops they use (``LayerList``, ``flatten``,
``reshape``, ``concat``, ``stack``).

Each JAX model is built from a seed; its parameters and BatchNorm
buffers go to numpy and load into the port's model by the reference's
state-dict keys (``load_numpy_state``).  The vision gradient oracle is
``jax.value_and_grad`` of the JAX model's training forward
(``functional_call``) under ``jax.jit``: op by op, the JAX package
compiles every primitive at each new shape, which for these models
takes most of a minute, and unlike ResNet's (``test_torch_vision.py``)
these networks have no max pool beside a ReLU, where the jitted
gradient of the JAX package parts from an exact run.  ERNIE's oracle
runs op by op; ERNIE runs at dropout 0, where the JAX BERT on the CPU
takes its einsum attention and the port the flash kernels' plain twins,
the same math.

Tolerances, f32: eval-mode outputs and losses 2e-5 relative to their
largest value, train-mode ones 1e-4 (BatchNorm over a few values a
channel at the last stages amplifies round-off); every gradient and
BatchNorm buffer within 1e-3 of its tensor's largest value, with a
floor for gradients that are 0 but for round-off (``_zoo_close``);
ERNIE's gradients within 1e-4 (no BatchNorm).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.autograd import no_grad as jax_no_grad
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.jit import functional_call
from paddle_tpu.models import ernie as jernie
from paddle_tpu.nn import functional as JF
from paddle_tpu.tensor import manipulation as jman
from paddle_tpu.vision import models as jax_models
from paddle_tpu_torch import amp, nn
from paddle_tpu_torch.models import ernie as pernie
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.tensor import manipulation as pman
from paddle_tpu_torch.vision import models

TOL, TRAIN_OUT, REL, ERNIE_REL = 2e-5, 1e-4, 1e-3, 1e-4
ROUNDOFF = 1e-3


def numpy_state(jm):
    params, buffers = jm.functional_state()
    return ({k: np.array(v) for k, v in params.items()},
            {k: np.array(v) for k, v in buffers.items()})


def rel_close(got, want, rel, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max()) / scale
    assert err <= rel, f'{what}: max |diff| / max |want| {err:.3e} > {rel}'


def zoo_close(got, want, rel, what):
    """Every tensor of ``got`` within ``rel`` of its tensor's largest
    value in ``want``, with one floor: a tensor whose true gradient is 0
    (a conv bias before BatchNorm, which removes any per-channel shift;
    a BatchNorm beta whose every path runs through 1 x 1 convolutions
    into BatchNorm) is round-off in both packages, so the scale is at
    least ROUNDOFF of the model's largest gradient."""
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), ROUNDOFF * top)
        err = float(np.abs(got[k] - w).max()) / scale
        assert err <= rel, f'{what} {k}: max |diff| / scale {err:.3e}'


def no_dropout(model):
    """Dropout at 0 in either package (their draws cannot match)."""
    for m in model.sublayers() if hasattr(model, 'sublayers') else \
            model.modules():
        if type(m).__name__ == 'Dropout':
            m.p = 0.0
    return model


def jax_grads(jm, x, y, cot=None):
    """``jax.jit(jax.value_and_grad)`` of CE(model(x), y) in training
    mode, or of ``sum(model(x) * cot)`` for a headless model: (loss,
    output, grads, buffers after the forward)."""
    params, buffers = jm.functional_state()

    def loss_of(p, x, y, cot):
        out, new = functional_call(jm, p, buffers, (x,), training=True)
        if cot is not None:
            return jnp.sum(out * cot), (out, new)
        with jax_no_grad():
            loss = JF.cross_entropy(JaxTensor._from_value(out),
                                    JaxTensor._from_value(y))
        return loss.value.mean(), (out, new)

    (loss, (out, new)), grads = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))(
            params, jnp.asarray(x), None if y is None else jnp.asarray(y),
            None if cot is None else jnp.asarray(cot))
    return (float(loss), np.asarray(out),
            {k: np.asarray(v) for k, v in grads.items()},
            {k: np.asarray(v) for k, v in new.items()})


def port_grads(pm, x, y, cot=None):
    pm.train()
    out = pm(torch.from_numpy(x))
    if cot is not None:
        loss = (out * torch.from_numpy(cot)).sum()
    else:
        loss = F.cross_entropy(out, torch.from_numpy(y))
    loss.backward()
    return (float(loss.detach()), out.detach().numpy(),
            {n: p.grad.numpy() for n, p in pm.named_parameters()},
            {n: b.numpy() for n, b in pm.named_buffers()})


def test_vgg11_bn_headless_train_mode_matches_jax():
    """``vgg11(batch_norm=True, num_classes=0)`` at B 2 x 32 x 32 in
    training mode: the features, the gradients of ``sum(features * cot)``
    and the BatchNorm buffers."""
    paddle.seed(0)
    jm = jax_models.vgg11(batch_norm=True, num_classes=0)
    state = numpy_state(jm)
    pm = models.vgg11(device='cpu', batch_norm=True, num_classes=0) \
        .load_numpy_state(*state)
    assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} == {
        k: v.shape for k, v in {**state[0], **state[1]}.items()}
    rs = np.random.RandomState(1)
    x = rs.randn(2, 3, 32, 32).astype(np.float32)
    cot = rs.randn(2, 512, 7, 7).astype(np.float32)
    w_loss, w_out, w_g, w_b = jax_grads(jm, x, None, cot)
    g_loss, g_out, g_g, g_b = port_grads(pm, x, None, cot)
    rel_close(g_out, w_out, TRAIN_OUT, 'features')
    np.testing.assert_allclose(g_loss, w_loss, rtol=TRAIN_OUT)
    zoo_close(g_g, w_g, REL, 'gradient')
    zoo_close(g_b, w_b, REL, 'buffer')


def test_vgg16_classifier_forward_matches_jax():
    """VGG-16 with its 25088-4096-4096 classifier (dropout off in eval),
    forward only, at B 2 x 32 x 32: the 7 x 7 adaptive pool spreads the
    1 x 1 feature map over the classifier's 25088 inputs."""
    paddle.seed(0)
    jm = jax_models.vgg16(num_classes=10)
    pm = models.vgg16(device='cpu', num_classes=10).load_numpy_state(
        *numpy_state(jm))
    assert tuple(pm.classifier[0].weight.shape) == (25088, 4096)
    x = np.random.RandomState(2).randn(2, 3, 32, 32).astype(np.float32)
    jm.eval()
    want = np.asarray(jax.jit(lambda v: jm(JaxTensor._from_value(v)).value)(
        jnp.asarray(x)))
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 10)
    rel_close(got, want, TOL, 'logits')


def test_headless_and_poolless_models_and_pretrained_raise():
    x = torch.zeros(1, 3, 64, 64)
    assert models.mobilenet_v1(device='cpu', num_classes=0,
                               with_pool=False)(x).shape == (1, 1024, 2, 2)
    assert models.mobilenet_v2(device='cpu', num_classes=0)(x).shape == \
        (1, 1280, 1, 1)
    assert models.vgg13(device='cpu', num_classes=0, with_pool=False)(
        x).shape == (1, 512, 2, 2)
    for fn in (models.vgg11, models.vgg19, models.mobilenet_v1,
               models.mobilenet_v2):
        with pytest.raises(NotImplementedError):
            fn(pretrained=True, device='cpu')


ERNIE_KW = dict(vocab_size=256, hidden_size=128, num_heads=2, num_layers=2,
                max_seq_len=64, dropout=0.0)


@pytest.fixture(scope='module')
def ernie():
    paddle.seed(7)
    jm = jernie.ernie_tiny(**ERNIE_KW)
    host = {k: np.array(v) for k, v in jm.functional_state()[0].items()}
    rs = np.random.RandomState(0)
    B, T = 2, 64
    ids = rs.randint(0, 256, (B, T)).astype(np.int64)
    types = rs.randint(0, 4, (B, T)).astype(np.int64)
    mlm = np.where(rs.rand(B, T) < 0.15, rs.randint(0, 256, (B, T)),
                   -100).astype(np.int64)
    nsp = rs.randint(0, 2, (B,)).astype(np.int64)
    return jm, host, (ids, types, mlm, nsp)


def _jt(a):
    return JaxTensor._from_value(jnp.asarray(a))


def test_ernie_config_and_keys_are_the_references(ernie):
    jm, host, _ = ernie
    assert vars(pernie.ErnieConfig()) == vars(jernie.ErnieConfig())
    cfg = pernie.ErnieConfig()
    assert (cfg.vocab_size, cfg.type_vocab_size, cfg.max_seq_len) == \
        (18000, 4, 513)
    pm = pernie.ernie_tiny(device='cpu', **ERNIE_KW).load_numpy_state(host)
    assert isinstance(pm, pernie.ErnieForPretraining)
    assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} == \
        {k: v.shape for k, v in host.items()}
    base = pernie.ernie_base(device='cpu', num_layers=1)
    assert tuple(base.bert.type_emb.weight.shape) == (4, 768)
    assert tuple(base.bert.word_emb.weight.shape) == (18000, 768)


@pytest.mark.parametrize('fused_head', [True, False])
def test_ernie_loss_and_every_gradient_match_jax(ernie, fused_head):
    jm, host, batch = ernie
    ids, types, mlm, nsp = batch
    jm.config.fused_head = fused_head
    params, buffers = jm.functional_state()

    def loss_of(p):
        saved = jm.functional_state()
        jm.load_functional_state(p, buffers)
        jm.train()
        try:
            with jax_no_grad():
                return jm.loss(jm(_jt(ids), _jt(types)), _jt(mlm),
                               _jt(nsp)).value
        finally:
            jm.load_functional_state(*saved)

    want_loss, want = jax.value_and_grad(loss_of)(params)
    pm = pernie.ernie_tiny(device='cpu', fused_head=fused_head,
                           **ERNIE_KW).load_numpy_state(host)
    loss = pm.loss(pm(torch.from_numpy(ids), torch.from_numpy(types)),
                   torch.from_numpy(mlm), torch.from_numpy(nsp))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=TOL)
    loss.backward()
    got = dict(pm.named_parameters())
    assert set(got) == set(want)
    for k, w in want.items():
        rel_close(got[k].grad.numpy(), np.asarray(w), ERNIE_REL, k)


def test_layer_list_keys_slices_and_edits():
    """Keys ``tables.0.weight``..., a slice is a new ``LayerList`` of
    the same layers, and ``append``/``insert``/``extend``/item
    assignment renumber as the reference's do."""
    from paddle_tpu import nn as jnn
    layers = [nn.Linear(2, i + 1, device='cpu') for i in range(3)]
    jlayers = [jnn.Linear(2, i + 1) for i in range(3)]
    holder, jholder = torch.nn.Module(), jnn.Layer()
    holder.tables = nn.LayerList(layers)
    jholder.tables = jnn.LayerList(jlayers)
    assert list(holder.state_dict()) == list(jholder.state_dict())
    part = holder.tables[1:]
    assert isinstance(part, nn.LayerList) and list(part) == layers[1:]
    assert list(part.state_dict()) == list(jholder.tables[1:].state_dict())
    assert holder.tables[-1] is layers[2] and len(holder.tables) == 3
    for ll, mk in ((holder.tables, lambda: nn.Linear(2, 9, device='cpu')),
                   (jholder.tables, lambda: jnn.Linear(2, 9))):
        ll.append(mk())
        ll.insert(1, mk())
        ll.extend([mk()])
        ll[0] = mk()
    assert [tuple(v.shape) for v in holder.state_dict().values()] == [
        tuple(v.shape) for v in jholder.state_dict().values()]
    assert list(holder.state_dict()) == list(jholder.state_dict())
    assert nn.LayerList().__len__() == 0


@pytest.mark.parametrize('start,stop', [(0, -1), (1, -1), (1, 2), (-3, -2),
                                        (2, 2)])
def test_flatten_matches_jax_and_casts_as_the_reference(start, stop):
    x = np.random.RandomState(0).randn(2, 3, 4, 5).astype(np.float32)
    want = np.asarray(jman.flatten(paddle.to_tensor(x), start, stop).value)
    got = pman.flatten(torch.from_numpy(x), start, stop)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    with amp.auto_cast(level='O2'):
        assert pman.flatten(torch.from_numpy(x), start, stop).dtype == \
            torch.bfloat16
    with amp.auto_cast(level='O1'):
        assert pman.flatten(torch.from_numpy(x), start, stop).dtype == \
            torch.float32


def test_reshape_concat_stack_match_jax():
    rs = np.random.RandomState(1)
    a, b = rs.randn(2, 3).astype(np.float32), rs.randn(2, 3).astype(
        np.float32)
    ja, jb = paddle.to_tensor(a), paddle.to_tensor(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    pairs = [(jman.reshape(ja, [3, -1]), pman.reshape(ta, [3, -1])),
             (jman.concat([ja, jb], axis=1), pman.concat([ta, tb], axis=1)),
             (jman.stack([ja, jb], axis=1), pman.stack([ta, tb], axis=1)),
             (jman.flatten(paddle.to_tensor(np.float32(3))),
              pman.flatten(torch.tensor(3.0)))]
    for want, got in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want.value))
    with amp.auto_cast(level='O2'):
        assert pman.concat([ta, tb.to(torch.bfloat16)]).dtype == \
            torch.bfloat16


def test_new_entry_points_without_device_raise_without_cuda(monkeypatch):
    """Wide&Deep, DeepFM, ERNIE, VGG and the MobileNets run on the card
    unless given ``device='cpu'``: with no card and no device they
    raise, as every entry point does."""
    from paddle_tpu_torch.models import DeepFM, WideDeep
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for build in (lambda: WideDeep([5, 3]), lambda: DeepFM([5, 3]),
                  lambda: pernie.ernie_tiny(), lambda: models.vgg11(),
                  lambda: models.mobilenet_v1(scale=0.25),
                  lambda: models.mobilenet_v2(scale=0.25)):
        with pytest.raises(RuntimeError, match='CUDA'):
            build()
