"""The port's ``interpolate``, ``affine_grid``/``grid_sample`` and the
rest of the vision functionals and layers against the JAX package's,
on the CPU.

``interpolate`` is the reference's ``jax.image.resize``: every mode up
and down, by ``size`` and by ``scale_factor``, NCHW and NHWC, 1-, 2-
and 3-d, outputs within 2e-5 and gradients within 1e-4
(``torch_tensor_oracle.check``).  The traps are shown apart from
PyTorch's own ``interpolate``: bilinear downsampling is antialiased
(``[[0..15]]`` at 4x4 to 2x2 gives ``[[3.571, 5.143], [9.857,
11.429]]``, not ``[[2.5, 4.5], [10.5, 12.5]]``), bicubic is Keys' cubic
with a = -0.5 (not -0.75), ``'area'`` is linear and nearest takes
index ``i * in // out``.  ``grid_sample`` is held at every mode,
padding and ``align_corners``, the grid's gradient included.
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


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device('cpu')
    yield
    paddle.set_device(None)


def _x(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# (shape, kwargs)
RESIZE_CASES = [
    ((2, 3, 5, 6), dict(size=[10, 12], mode='nearest')),
    ((2, 3, 8, 8), dict(size=[3, 5], mode='nearest')),
    ((2, 3, 4, 4), dict(scale_factor=2, mode='nearest')),
    ((2, 5, 6, 3), dict(scale_factor=[1.5, 2], mode='nearest',
                        data_format='NHWC')),
    ((2, 3, 5, 6), dict(size=[11, 9], mode='bilinear')),
    ((2, 3, 9, 8), dict(size=[4, 3], mode='bilinear')),
    ((2, 3, 7, 7), dict(scale_factor=0.5, mode='bilinear',
                        align_corners=True)),
    ((2, 6, 5, 3), dict(size=[7, 4], mode='bilinear', data_format='NHWC')),
    ((2, 3, 5, 6), dict(size=[12, 13], mode='bicubic')),
    ((2, 3, 12, 10), dict(size=[5, 4], mode='bicubic')),
    ((2, 3, 9, 9), dict(size=[4, 4], mode='area')),
    ((2, 3, 7), dict(size=[15], mode='linear')),
    ((2, 3, 14), dict(size=[5], mode='linear', data_format='NCW')),
    ((2, 7, 3), dict(scale_factor=2.5, mode='linear', data_format='NWC')),
    ((1, 2, 3, 4, 5), dict(size=[6, 2, 7], mode='trilinear')),
    ((1, 2, 4, 4, 4), dict(scale_factor=2, mode='nearest',
                           data_format='NCDHW')),
    ((1, 4, 4, 4, 2), dict(size=[2, 6, 3], mode='trilinear',
                           data_format='NDHWC')),
    ((2, 3, 6, 6), dict(size=[6, 9], mode='bilinear')),     # one axis kept
]


@pytest.mark.parametrize('shape,kw', RESIZE_CASES,
                         ids=lambda c: str(c).replace(' ', ''))
def test_interpolate_matches_jax(shape, kw):
    check(lambda P, x: P.nn.functional.interpolate(x, **kw), [_x(*shape)])


def test_upsample_is_interpolate():
    check(lambda P, x: P.nn.functional.upsample(
        x, scale_factor=3, mode='bilinear'), [_x(1, 2, 3, 3)])


def test_bilinear_downsampling_is_antialiased_not_torchs():
    x = torch.arange(16, dtype=torch.float32).reshape(1, 1, 4, 4)
    got = F.interpolate(x, size=[2, 2], mode='bilinear')
    torch.testing.assert_close(got[0, 0], torch.tensor(
        [[3.5714, 5.1429], [9.8571, 11.4286]]), rtol=0, atol=1e-4)
    theirs = torch.nn.functional.interpolate(x, size=[2, 2],
                                             mode='bilinear')
    torch.testing.assert_close(theirs[0, 0], torch.tensor(
        [[2.5, 4.5], [10.5, 12.5]]))


def test_bicubic_is_keys_half_not_torchs_three_quarters():
    """Upsampling, where neither side antialiases: Keys' a = -0.5
    (the reference) against PyTorch's a = -0.75."""
    x = torch.from_numpy(_x(1, 1, 5, 5))
    ours = F.interpolate(x, size=[10, 10], mode='bicubic')
    theirs = torch.nn.functional.interpolate(x, size=[10, 10],
                                             mode='bicubic')
    assert float((ours - theirs).abs().max()) > 1e-2
    want = jpaddle.nn.functional.interpolate(jpaddle.to_tensor(x.numpy()),
                                             size=[10, 10], mode='bicubic')
    np.testing.assert_allclose(ours.numpy(), np.asarray(want.numpy()),
                               rtol=2e-5, atol=2e-5)


def test_nearest_takes_i_times_in_over_out():
    x = torch.arange(5, dtype=torch.float32).reshape(1, 1, 5)
    got = F.interpolate(x, size=[3], mode='nearest', data_format='NCW')
    assert got.flatten().tolist() == [0.0, 1.0, 3.0]
    assert F.interpolate(x, scale_factor=1.7, mode='nearest',
                         data_format='NCW').shape[-1] == int(5 * 1.7)


def test_interpolate_bf16_and_under_o2():
    x = _x(2, 3, 6, 6)
    check(lambda P, x: P.cast(P.nn.functional.interpolate(
        P.cast(x, 'bfloat16'), size=[4, 9], mode='bilinear'), 'float32'),
        [x], tol=2e-2, grad_tol=2e-2)
    with paddle.amp.auto_cast(level='O2'):
        out = F.interpolate(torch.from_numpy(x), scale_factor=2)
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize('align', [True, False])
def test_affine_grid_matches_jax(align):
    theta = _x(2, 2, 3, seed=1, scale=0.5)
    check(lambda P, t: P.nn.functional.affine_grid(
        t, [2, 3, 5, 7], align_corners=align), [theta])


@pytest.mark.parametrize('mode', ['bilinear', 'nearest'])
@pytest.mark.parametrize('padding', ['zeros', 'border', 'reflection'])
@pytest.mark.parametrize('align', [True, False])
def test_grid_sample_matches_jax(mode, padding, align):
    x = _x(2, 3, 5, 6)
    grid = np.random.RandomState(2).uniform(
        -1.4, 1.4, (2, 4, 7, 2)).astype(np.float32)
    check(lambda P, x, g: P.nn.functional.grid_sample(
        x, g, mode=mode, padding_mode=padding, align_corners=align),
        [x, grid])


def test_affine_grid_into_grid_sample_matches_jax():
    theta = np.array([[[0.9, -0.3, 0.1], [0.2, 1.1, -0.2]],
                      [[1.2, 0.0, 0.3], [0.1, 0.8, 0.0]]], np.float32)
    check(lambda P, x, t: P.nn.functional.grid_sample(
        x, P.nn.functional.affine_grid(t, [2, 3, 6, 5])),
        [_x(2, 3, 5, 4), theta])


@pytest.mark.parametrize('kw', [
    dict(kernel_sizes=3), dict(kernel_sizes=[2, 3], strides=2, paddings=1),
    dict(kernel_sizes=2, dilations=2, paddings=[1, 0])])
def test_unfold_matches_jax(kw):
    check(lambda P, x: P.nn.functional.unfold(x, **kw), [_x(2, 3, 6, 7)])


def test_bilinear_matches_jax():
    check(lambda P, a, b, w, c: P.nn.functional.bilinear(a, b, w, c),
          [_x(4, 3), _x(4, 5, seed=1), _x(6, 3, 5, seed=2), _x(6, seed=3)])


@pytest.mark.parametrize('df', ['NCHW', 'NHWC'])
def test_pixel_shuffle_matches_jax(df):
    shape = (2, 12, 3, 4) if df == 'NCHW' else (2, 3, 4, 12)
    check(lambda P, x: P.nn.functional.pixel_shuffle(x, 2, df),
          [_x(*shape)])


@pytest.mark.parametrize('offset,dim1,dim2', [(0, -2, -1), (1, 0, 2),
                                              (-2, -1, -2), (2, 1, 0)])
def test_diag_embed_matches_jax(offset, dim1, dim2):
    check(lambda P, x: P.nn.functional.diag_embed(x, offset, dim1, dim2),
          [_x(2, 3, 4)])


def test_tanh_inplace_is_the_tensor_ops():
    x = torch.from_numpy(_x(3, 4))
    want = torch.tanh(x)
    assert F.tanh_(x) is x and torch.equal(x, want)


@pytest.mark.parametrize('name,args,inputs', [
    ('Upsample', dict(scale_factor=2, mode='bilinear'), [(2, 3, 4, 4)]),
    ('UpsamplingNearest2D', dict(size=[7, 5]), [(2, 3, 4, 4)]),
    ('UpsamplingBilinear2D', dict(scale_factor=0.5), [(2, 3, 8, 6)]),
    ('Unfold', dict(kernel_sizes=2, strides=2), [(2, 3, 4, 4)]),
    ('PixelShuffle', dict(upscale_factor=3), [(2, 18, 2, 3)]),
    ('PairwiseDistance', dict(p=3.0, keepdim=True), [(4, 6), (4, 6)]),
    ('Bilinear', dict(in1_features=3, in2_features=5, out_features=4),
     [(6, 3), (6, 5)])])
def test_vision_layers_match_jax(name, args, inputs):
    jpaddle.seed(0)
    jm = getattr(jpaddle.nn, name)(**args)
    pm = getattr(nn, name)(**args)
    assert set(pm.state_dict()) == set(jm.state_dict())
    if list(pm.state_dict()):
        load_from_jax(pm, jm)
    arrays = [_x(*s, seed=i) for i, s in enumerate(inputs)]
    compare_vjp(jm, pm, lambda m, *v: m(*v), arrays, 2e-5, 1e-4)
