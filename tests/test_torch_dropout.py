"""Dropout and the global random state of the port, on the CPU.

The port draws its keep masks from ``core.rng``'s per-device
``torch.Generator``; the reference draws from ``jax.random``.  The bits
cannot agree (ROADMAP Queue 3), so the reference is held to what a draw
does not decide: the identity cases (p = 0, eval, and a p so small that
``1 - p`` rounds to 1 in f32, where both keep every element and scale
by exactly 1), zeros at p = 1, ``downscale_in_infer``, and the same
output for the same mask.  The draws themselves are checked by their
statistics: the keep rate within 5 binomial standard deviations, the
``1 / (1 - p)`` scale, ``axis`` broadcasting, the gradient equal to
mask x scale, and the same draws after the same ``seed``.

Tolerances: exact where the arithmetic is (identities, zeros, the
gradient, the reference's output on the port's mask); 1e-6 on scaled
values (one f32 multiply in either package).
"""
import random

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import amp
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.nn import Dropout
from paddle_tpu_torch.nn import functional as F


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax(x, **kw):
    return np.asarray(JF.dropout(paddle.to_tensor(x), **kw).value)


@pytest.mark.parametrize('kw', [dict(p=0.0), dict(p=0.5, training=False),
                                dict(p=1e-9), dict(p=1e-9, axis=[0])])
def test_identity_cases_match_the_reference(kw):
    x = _x(4, 6, 8)
    got = F.dropout(torch.from_numpy(x), **kw)
    assert np.array_equal(got.numpy(), x)
    assert np.array_equal(_jax(x, **kw), x)


def test_p_one_zeros_and_downscale_in_infer_match_the_reference():
    x = _x(3, 5)
    assert np.array_equal(F.dropout(torch.from_numpy(x), p=1.0).numpy(),
                          np.zeros_like(x))
    assert np.array_equal(_jax(x, p=1.0), np.zeros_like(x))
    kw = dict(p=0.3, training=False, mode='downscale_in_infer')
    np.testing.assert_allclose(F.dropout(torch.from_numpy(x), **kw).numpy(),
                               _jax(x, **kw), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_jax(x, **kw), x * 0.7, rtol=1e-6)


@pytest.mark.parametrize('p', [0.1, 0.5])
def test_keep_rate_and_scale(p):
    rng.seed(0)
    x = torch.ones(200, 500)
    y = F.dropout(x, p=p)
    kept = y != 0
    n = x.numel()
    rate = float(kept.float().mean())
    sd = np.sqrt(p * (1 - p) / n)
    assert abs(rate - (1 - p)) <= 5 * sd, rate
    np.testing.assert_allclose(y[kept].numpy(), 1.0 / (1.0 - p), rtol=1e-6)
    # downscale_in_infer keeps the values as they are in training
    z = F.dropout(x, p=p, mode='downscale_in_infer')
    assert set(z.unique().tolist()) <= {0.0, 1.0}


def test_axis_shares_one_draw_along_the_other_axes():
    rng.seed(1)
    x = torch.ones(8, 16, 32)
    y = F.dropout(x, p=0.5, axis=[0, 2])
    keep = y != 0
    # the same decision for every index of axis 1
    assert torch.equal(keep, keep[:, :1, :].expand_as(keep))
    assert 0 < int(keep[:, 0, :].sum()) < 8 * 32
    y1 = F.dropout(x, p=0.5, axis=1)
    k1 = y1 != 0
    assert torch.equal(k1, k1[:1, :, :1].expand_as(k1))


def test_gradient_is_mask_times_scale():
    rng.seed(2)
    x = torch.from_numpy(_x(6, 7)).requires_grad_()
    g = torch.from_numpy(_x(6, 7, seed=1))
    y = F.dropout(x, p=0.25)
    y.backward(g)
    keep = (y.detach() != 0).float()
    np.testing.assert_allclose(x.grad.numpy(), (g * keep / 0.75).numpy(),
                               rtol=1e-6, atol=1e-7)
    # the reference's forward on the same mask: x / (1 - p) where kept
    want = np.where(keep.numpy() > 0, x.detach().numpy() / 0.75, 0.0)
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=1e-6)


def test_seed_makes_draws_deterministic_and_seeds_the_host():
    x = torch.ones(64, 64)
    paddle_tpu_torch.seed(3)
    a = F.dropout(x, p=0.5)
    h1 = (random.random(), np.random.rand())
    paddle_tpu_torch.seed(3)
    b = F.dropout(x, p=0.5)
    h2 = (random.random(), np.random.rand())
    assert torch.equal(a, b) and h1 == h2
    assert rng.get_seed() == 3
    c = F.dropout(x, p=0.5)
    assert not torch.equal(b, c)           # the generator moves on
    assert rng.generator('cpu') is rng.generator(torch.device('cpu'))
    rng.seed(4)
    assert not torch.equal(a, F.dropout(x, p=0.5))


def test_dropout_layer_follows_the_training_flag():
    layer = Dropout(p=0.5)
    x = torch.ones(32, 32)
    assert layer.training and not torch.equal(layer(x), x)
    layer.eval()
    assert torch.equal(layer(x), x)
    infer = Dropout(p=0.5, mode='downscale_in_infer').eval()
    assert torch.equal(infer(x), x * 0.5)


def test_amp_casts_dropout_as_a_gray_op():
    x = torch.ones(4, 4)
    with amp.auto_cast(level='O2'):
        assert F.dropout(x, p=0.1).dtype == torch.bfloat16
    with amp.auto_cast(level='O1'):
        assert F.dropout(x, p=0.1).dtype == torch.float32
        assert F.dropout(x.to(torch.bfloat16), p=0.1).dtype == \
            torch.bfloat16


def test_bad_arguments_raise():
    x = torch.ones(2)
    with pytest.raises(ValueError, match='mode'):
        F.dropout(x, 0.1, mode='scale')
    with pytest.raises(ValueError, match='probability'):
        F.dropout(x, 1.5)
    with pytest.raises(ValueError, match='probability'):
        F.dropout(x, -0.1)
