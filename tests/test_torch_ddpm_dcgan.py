"""The smoke's two vision models, DDPM's U-Net and DCGAN, on both
packages at small widths, on the CPU.

``chip_smoke.ddpm_unet`` and ``chip_smoke.dcgan_models`` are one code
for both packages, built from the public ``nn`` layers.  The JAX model
is built from a seed and its weights carried into the port's through
``convert.load_numpy_state``.

- U-Net: ch 32, multipliers (1, 2), one residual block a level,
  attention at 8^2 (its scores through ``F.softmax``: the reference's
  CPU path, the port's softmax twin), GroupNorm 8, 16^2 images, T 1000.
  Output, every parameter's gradient and the images' gradient of
  ``sum(out * cot)`` by ``jax.value_and_grad`` (under ``jax.jit``)
  against ``backward``
  (2e-5 and 1e-4 of the largest magnitude; the attention key's bias has
  a true gradient of 0, so both sides hold round-off there and each is
  checked to be tiny); then two steps of each package's
  ``ParallelTrainer`` (Adam 2e-4, global-norm clip 1): f32 losses within
  1e-5 and parameters within 1e-4 (the key bias within ``2 * lr *
  steps``), and under bf16 O2 the losses within 2^-7, relative.
- DCGAN: ngf = ndf = 8 at 16^2 (two transposed convolutions up, two
  convolutions down), B 4: one D + G iteration as a user writes it (two
  Adam optimizers, ``backward``, ``step``, ``clear_grad``) in both
  packages: both losses within 1e-5 and each network's gradients as its
  ``step`` sees them within 1e-4; the parameters after the iteration
  within ``2 * lr`` (Adam's first step is ``lr * g / (|g| + eps)``, so
  an element whose gradient is near eps moves by a fraction of ``lr``
  that the gradient's round-off decides).
"""
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.distributed.fleet import DistributedStrategy as JaxStrategy
from paddle_tpu.parallel import ParallelTrainer as JaxTrainer
import paddle_tpu_torch as paddle
from paddle_tpu_torch.convert import load_numpy_state
from torch_seq_oracle import (close, compare_vjp, host_state, load_from_jax,
                              np32)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (the smoke's models, one code for both)

UNET = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            dropout=0.0, resolution=16, groups=8)
DCGAN = dict(nz=16, ngf=8, ndf=8, image=16)
KEY_BIAS = ('k.bias',)


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device('cpu')
    yield
    paddle.set_device(None)


@pytest.fixture(scope='module')
def jax_unet():
    """The JAX U-Net, built once (its init runs op by op), and its
    initial state as numpy."""
    jpaddle.seed(0)
    jm = chip_smoke.ddpm_unet(jpaddle, **UNET)
    return jm, host_state(jm)


def _port_unet(state):
    paddle.set_device('cpu')
    try:
        pm = chip_smoke.ddpm_unet(paddle, **UNET)
    finally:
        paddle.set_device(None)
    load_numpy_state(pm, state)
    return pm


@pytest.fixture
def unets(jax_unet):
    jm, state = jax_unet
    jm.set_state_dict(state)
    return jm, _port_unet(state)


def test_unet_structure(unets):
    """The same state-dict keys and shapes; the attention blocks where
    the configuration puts them (one at 8^2 down, the middle, two at 8^2
    up)."""
    jm, pm = unets
    assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} == {
        k: tuple(v.shape) for k, v in jm.state_dict().items()}
    attn = [n for n, m in pm.named_modules() if type(m).__name__ ==
            'AttnBlock']
    assert attn == ['down_attn.1', 'mid_attn', 'up_attn.0', 'up_attn.1']


def test_unet_matches_jax(unets):
    jm, pm = unets
    x0, t, noise, _ = chip_smoke.ddpm_batch(3, resolution=16)
    compare_vjp(jm, pm, lambda m, a, b, c: m(a, b, c), [x0, t, noise],
                2e-5, 1e-4, skip=KEY_BIAS, jit=True)


def test_unet_launches_one_softmax_an_attention_block(unets, monkeypatch):
    """Each attention block's ``F.softmax`` reaches ``fused_softmax``
    (the kernel on the card, its twin here) at rows of HW: here 4 at 8^2
    (the middle block is at the lowest level, 8^2 too); at the smoke's
    widths 5 at 16^2 (2 down, 3 up) and the middle's at 4^2 a
    forward."""
    import importlib
    fsm = importlib.import_module('paddle_tpu_torch.ops.fused_softmax')
    rows = []
    real = fsm._reference

    def spy(x, mask):
        rows.append(tuple(x.shape))
        return real(x, mask)
    monkeypatch.setattr(fsm, '_reference', spy)
    _, pm = unets
    x0, t, noise, _ = chip_smoke.ddpm_batch(2, resolution=16)
    with torch.no_grad():
        pm(*map(torch.from_numpy, (x0, t, noise)))
    assert rows == [(2, 64, 64)] * 4
    cfg = chip_smoke.DDPM_KW
    n = cfg['num_res_blocks']
    assert cfg['attn_resolutions'] == (16,) and len(cfg['ch_mult']) == 4
    assert chip_smoke.DDPM_SOFTMAX_ROWS == {16 * 16: n + (n + 1),
                                            (32 // 8) ** 2: 1}


def test_unet_at_published_widths_has_35_7m_parameters():
    """Built under ``deferred_init`` (allocated, not drawn): 35.7 M
    parameters, as the paper reports for its CIFAR-10 model."""
    from paddle_tpu_torch.nn.layer.layers import deferred_init
    with deferred_init():
        m = chip_smoke.ddpm_unet(paddle, **chip_smoke.DDPM_KW)
    n = sum(p.numel() for p in m.parameters())
    assert 35.6e6 < n < 35.8e6, n


def _trainers(unets, o2):
    jm, pm = unets
    return (chip_smoke.ddpm_trainer(jpaddle, jm, o2, trainer_cls=JaxTrainer,
                                    strategy_cls=JaxStrategy),
            chip_smoke.ddpm_trainer(paddle, pm, o2))


@pytest.mark.parametrize('o2', [False, True], ids=['f32', 'bf16_o2'])
def test_unet_trains_as_the_jax_trainer(unets, o2):
    jtr, ptr = _trainers(unets, o2)
    batch = chip_smoke.ddpm_batch(4, resolution=16, seed=2)
    for _ in range(2):
        want = jtr.loss_float(jtr.step(*batch))
        got = ptr.loss_float(ptr.step(*batch))
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7 if o2 else 1e-5)
    if o2:
        assert all(p.dtype == torch.float32 for p in ptr.model.parameters())
        return
    for name, p in ptr.model.named_parameters():
        want = np.asarray(jtr.params[name])
        if name.endswith(KEY_BIAS):
            assert float(np.abs(np32(p) - want).max()) <= \
                2 * chip_smoke.DDPM_LR * 2, name
            continue
        close(np32(p), want, 1e-4, name)


def _dcgan(pkg):
    pkg.seed(0)
    return chip_smoke.dcgan_models(pkg, **DCGAN)


def test_dcgan_iteration_matches_jax():
    jg, jd = _dcgan(jpaddle)
    pg, pd = _dcgan(paddle)
    assert {k: tuple(v.shape) for k, v in pg.state_dict().items()} == {
        k: tuple(v.shape) for k, v in jg.state_dict().items()}
    load_from_jax(pg, jg)
    load_from_jax(pd, jd)
    real, z = chip_smoke.dcgan_batch(4, DCGAN['nz'], DCGAN['image'])
    jgrads, pgrads = {}, {}
    jl = chip_smoke.dcgan_iteration(
        jpaddle, jg, jd, *chip_smoke.dcgan_optimizers(jpaddle, jg, jd),
        jpaddle.to_tensor(real), jpaddle.to_tensor(z), jgrads)
    pl = chip_smoke.dcgan_iteration(
        paddle, pg, pd, *chip_smoke.dcgan_optimizers(paddle, pg, pd),
        torch.from_numpy(real), torch.from_numpy(z), pgrads)
    for a, b in zip(pl, jl):
        np.testing.assert_allclose(float(a.detach()), float(b.numpy()),
                                   rtol=1e-5)
    assert set(pgrads) == set(jgrads)
    for name, g in pgrads.items():
        close(np32(g), np32(jgrads[name]), 1e-4, f'gradient {name}')
    for prefix, pm, jm in (('G', pg, jg), ('D', pd, jd)):
        for name, want in jm.state_dict().items():
            gap = float(np.abs(np32(pm.state_dict()[name])
                               - np32(want)).max())
            assert gap <= 2 * chip_smoke.DCGAN_LR, (prefix, name, gap)


def test_dcgan_generator_shapes_and_init():
    """G maps z to 3 x 16^2 in (-1, 1) through 5 x 5 stride-2 transposed
    convolutions with ``output_padding`` 1; every conv and linear weight
    is N(0, 0.02).  At the smoke's widths: 1024 -> 512 -> 256 -> 128 ->
    3 at 64^2."""
    g, d = _dcgan(paddle)
    z = torch.randn(2, DCGAN['nz'])
    with torch.no_grad():
        img = g(z)
        logit = d(img)
    assert tuple(img.shape) == (2, 3, 16, 16) and tuple(logit.shape) == (2, 1)
    assert float(img.abs().max()) < 1.0
    ups = [m for m in g.modules() if isinstance(m, paddle.nn.Conv2DTranspose)]
    assert [m.output_padding for m in ups] == [1, 1]
    w = torch.cat([m.weight.detach().flatten() for m in g.modules()
                   if isinstance(m, (paddle.nn.Conv2DTranspose,
                                     paddle.nn.Linear))])
    assert abs(float(w.std()) - 0.02) < 1e-3
    with paddle.nn.layer.layers.deferred_init():
        g, d = chip_smoke.dcgan_models(paddle, **chip_smoke.DCGAN_KW)
    assert [(m.in_channels, m.out_channels) for m in g.modules()
            if isinstance(m, paddle.nn.Conv2DTranspose)] == [
        (1024, 512), (512, 256), (256, 128), (128, 3)]
    assert [m.out_channels for m in d.modules()
            if isinstance(m, paddle.nn.Conv2D)] == [128, 256, 512, 1024]
