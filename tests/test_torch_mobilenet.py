"""The port's MobileNet v1 and v2 against the JAX package's, on the CPU,
with the helpers and tolerances of ``test_torch_model_zoo.py``.

Each JAX model (``scale=0.25``, 10 classes) is built once for the module
from seed 0 and loaded into the port's by its state-dict keys.  Eval
mode and bf16 O2 at B 4 x 32 x 32, forward.  Train mode at B 4 x 64 x
64: the logits, the loss, every gradient (per tensor, with the
round-off floor of ``zoo_close``) and every BatchNorm buffer, with
dropout at 0 in both.  At 32 x 32 the last stages of both networks see
1 x 1 maps, so their BatchNorms normalise over the 4 images alone and
turn round-off into train-mode logits that part by 1.6e-4 (v1) and
2.6e-4 (v2) of their largest; at 64 x 64 (2 x 2 maps, 16 values a
channel) by 4e-5 and 2e-5, inside the 1e-4 bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.vision import models as jax_models
from paddle_tpu.vision.models import mobilenetv1 as jv1
from paddle_tpu.vision.models import mobilenetv2 as jv2
from paddle_tpu_torch import amp, nn
from paddle_tpu_torch.vision import models
from paddle_tpu_torch.vision.models import mobilenetv1 as pv1
from paddle_tpu_torch.vision.models import mobilenetv2 as pv2
from test_torch_model_zoo import (REL, TOL, TRAIN_OUT, jax_grads,
                                  no_dropout, numpy_state, port_grads,
                                  rel_close, zoo_close)

NAMES = ('mobilenet_v1', 'mobilenet_v2')
KW = dict(scale=0.25, num_classes=10)


@pytest.fixture(scope='module')
def pairs():
    out = {}
    for name in NAMES:
        paddle.seed(0)
        jm = no_dropout(getattr(jax_models, name)(**KW))
        state = numpy_state(jm)
        pm = no_dropout(getattr(models, name)(device='cpu', **KW)
                        .load_numpy_state(*state))
        out[name] = (jm, pm, state)
    return out


def _images(seed=1, size=32):
    rs = np.random.RandomState(seed)
    return (rs.randn(4, 3, size, size).astype(np.float32),
            rs.randint(0, 10, (4, 1)).astype(np.int64))


@pytest.mark.parametrize('name', NAMES)
def test_train_mode_logits_gradients_and_buffers_match_jax(pairs, name):
    jm, pm, state = pairs[name]
    assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} == {
        k: v.shape for k, v in {**state[0], **state[1]}.items()}
    pm.load_numpy_state(*state)
    for p in pm.parameters():
        p.grad = None
    x, y = _images(size=64)
    w_loss, w_out, w_g, w_b = jax_grads(jm, x, y)
    g_loss, g_out, g_g, g_b = port_grads(pm, x, y)
    rel_close(g_out, w_out, TRAIN_OUT, 'logits')
    np.testing.assert_allclose(g_loss, w_loss, rtol=TRAIN_OUT)
    zoo_close(g_g, w_g, REL, 'gradient')
    zoo_close(g_b, w_b, REL, 'buffer')


@pytest.mark.parametrize('name', NAMES)
@pytest.mark.parametrize('level', [None, 'O2'])
def test_eval_forward_matches_jax_in_f32_and_under_o2(pairs, name, level):
    """Eval mode on the initial running statistics: f32 within 2e-5 of
    the largest logit; bf16 O2 within 3e-2 (both packages round every
    conv, BatchNorm output and residual add to bf16, at other places
    inside the convolutions), the port's logits in bf16."""
    jm, pm, state = pairs[name]
    pm.load_numpy_state(*state)
    x, _ = _images(2)
    jm.eval()
    try:
        if level:
            with paddle.amp.auto_cast(level=level):
                want = jax.jit(lambda v: jm(JaxTensor._from_value(v)).value
                               )(jnp.asarray(x))
        else:
            want = jax.jit(lambda v: jm(JaxTensor._from_value(v)).value)(
                jnp.asarray(x))
    finally:
        jm.train()
    want = np.asarray(want.astype(jnp.float32))
    with torch.no_grad():
        if level:
            with amp.auto_cast(level=level):
                got = pm.eval()(torch.from_numpy(x))
            assert got.dtype == torch.bfloat16
        else:
            got = pm.eval()(torch.from_numpy(x))
    pm.train()
    rel_close(got.float().numpy(), want, 3e-2 if level else TOL, 'logits')


def test_depthwise_convs_and_widths_are_the_references():
    """The stage tables and ``_make_divisible`` are the reference's, so
    every width at every ``scale`` is; MobileNet v1's 13 depthwise
    convolutions are grouped per channel."""
    assert pv1._STAGES == jv1._STAGES and pv2._CFG == jv2._CFG
    for v in list(range(1, 400)) + [x * 0.25 for x in range(1, 2000)]:
        assert pv2._make_divisible(v) == jv2._make_divisible(v)
    for scale in (0.5, 1.0):
        for name in NAMES:
            pm = getattr(models, name)(device='cpu', scale=scale,
                                       num_classes=0)
            convs = [m for m in pm.modules() if isinstance(m, nn.Conv2D)]
            assert all(m.weight.shape[0] % 8 == 0 or name == 'mobilenet_v1'
                       for m in convs)
    convs = [m for m in models.mobilenet_v1(device='cpu').modules()
             if isinstance(m, nn.Conv2D) and m.groups > 1]
    assert len(convs) == 13
    assert all(m.groups == m.in_channels == m.out_channels and
               m.weight.shape[1] == 1 for m in convs)
    with pytest.raises(NotImplementedError):
        jax_models.mobilenet_v1(pretrained=True)
