"""Spatial-transformer functionals (counterpart of
``paddle_tpu/nn/functional/vision.py``): ``affine_grid`` and
``grid_sample``, composed as the reference composes them.

``grid_sample`` un-normalises the grid in f32 (``align_corners``, True
by default, maps -1 and 1 to the corner pixels' centres; otherwise to
their outer edges), reflects it for ``'reflection'`` (about the corner
centres, or about the pixel-area borders and then clipped), and reads
each corner by a gather at indices clipped into the image; in
``'zeros'`` a corner outside the image is masked to 0, in ``'border'``
the clipped gather is the border.  ``'bilinear'`` weighs the four
corners by the fractional parts, ``'nearest'`` rounds half to even.
The gradients are those of that composition (the grid's through the
weights, the image's a scatter-add of the gathers), not
``torch.nn.functional.grid_sample``'s.
"""
import torch

from ...amp import amp_cast

__all__ = ['affine_grid', 'grid_sample']


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """``theta [N, 2, 3]`` -> the sampling grid ``[N, H, W, 2]`` (x, y)
    in normalised [-1, 1] coordinates for ``out_shape`` ``(N, C, H,
    W)``."""
    theta, = amp_cast('affine_grid', theta)
    _, _, H, W = [int(s) for s in out_shape]
    f32 = torch.float32
    dev = theta.device
    if align_corners:
        ys = torch.linspace(-1.0, 1.0, H, dtype=f32, device=dev)
        xs = torch.linspace(-1.0, 1.0, W, dtype=f32, device=dev)
    else:
        ys = (torch.arange(H, dtype=f32, device=dev) * 2 + 1) / H - 1.0
        xs = (torch.arange(W, dtype=f32, device=dev) * 2 + 1) / W - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing='ij')
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum('hwk,nck->nhwc', base.to(theta.dtype), theta)


def _unnormalize(c, size, align_corners):
    if align_corners:
        return (c + 1.0) / 2.0 * (size - 1)
    return ((c + 1.0) * size - 1.0) / 2.0


def _reflect(c, size, align_corners):
    if align_corners:
        span = 2.0 * (size - 1)
        if span == 0.0:
            return torch.zeros_like(c)
        c = torch.remainder(c, span).abs()
        return torch.where(c > (size - 1), span - c, c)
    span = 2.0 * size
    c = torch.remainder(c + 0.5, span)
    c = torch.where(c > size, span - c, c) - 0.5
    return c.clamp(0.0, size - 1)


def grid_sample(x, grid, mode='bilinear', padding_mode='zeros',
                align_corners=True, name=None):
    """``x [N, C, H, W]`` sampled at ``grid [N, Ho, Wo, 2]`` (x, y in
    [-1, 1]) -> ``[N, C, Ho, Wo]`` in x's dtype (module docstring)."""
    if mode not in ('bilinear', 'nearest'):
        raise ValueError(f'grid_sample: unsupported mode {mode!r}')
    if padding_mode not in ('zeros', 'border', 'reflection'):
        raise ValueError(
            f'grid_sample: unsupported padding_mode {padding_mode!r}')
    x, grid = amp_cast('grid_sample', x, grid)
    N, _, H, W = x.shape
    px = _unnormalize(grid[..., 0].float(), W, align_corners)
    py = _unnormalize(grid[..., 1].float(), H, align_corners)
    if padding_mode == 'reflection':
        px = _reflect(px, W, align_corners)
        py = _reflect(py, H, align_corners)
    batch = torch.arange(N, device=x.device)[:, None, None]
    image = x.movedim(1, -1)                            # [N, H, W, C]

    def gather(yy, xx):
        yi = yy.to(torch.int32).clamp(0, H - 1).long()
        xi = xx.to(torch.int32).clamp(0, W - 1).long()
        out = image[batch, yi, xi]                      # [N, Ho, Wo, C]
        if padding_mode == 'zeros':
            inb = ((yy >= 0) & (yy <= H - 1) & (xx >= 0)
                   & (xx <= W - 1)).to(x.dtype)
            out = out * inb[..., None]
        return out

    if mode == 'nearest':
        out = gather(torch.round(py), torch.round(px))
    else:
        y0, x0 = torch.floor(py), torch.floor(px)
        wy, wx = (py - y0)[..., None], (px - x0)[..., None]
        out = (gather(y0, x0) * (1 - wy) * (1 - wx)
               + gather(y0, x0 + 1) * (1 - wy) * wx
               + gather(y0 + 1, x0) * wy * (1 - wx)
               + gather(y0 + 1, x0 + 1) * wy * wx)
    return out.movedim(-1, 1).to(x.dtype)
