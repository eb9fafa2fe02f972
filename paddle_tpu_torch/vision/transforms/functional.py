"""Functional image transforms on numpy HWC arrays (counterpart of
``paddle_tpu/vision/transforms/functional.py``, a copy of its numpy
code, so each output equals the reference's bit for bit).

Paddle's own version leans on PIL/cv2; these are numpy-native: host-side
preprocessing feeds the card through the DataLoader's prefetch ring, so
they must be cheap, dependency-free and thread-safe.

Images are numpy arrays, shape (H, W, C) or (H, W), dtype uint8 or float.
"""
import numbers

import numpy as np

__all__ = ['to_tensor', 'resize', 'crop', 'center_crop', 'hflip', 'vflip',
           'pad', 'rotate', 'to_grayscale', 'normalize',
           'adjust_brightness', 'adjust_contrast', 'adjust_saturation',
           'adjust_hue']


def _as_hwc(img):
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def to_tensor(img, data_format='CHW'):
    """uint8 HWC -> float32 scaled to [0,1], CHW or HWC."""
    img = _as_hwc(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    else:
        img = img.astype(np.float32)
    if data_format.upper() == 'CHW':
        img = np.transpose(img, (2, 0, 1))
    return img


def resize(img, size, interpolation='bilinear'):
    """Resize to `size` (int: short side; (h, w): exact)."""
    img = _as_hwc(img)
    h, w = img.shape[:2]
    if isinstance(size, int):
        if h <= w:
            oh, ow = size, max(1, int(round(w * size / h)))
        else:
            oh, ow = max(1, int(round(h * size / w))), size
    else:
        oh, ow = int(size[0]), int(size[1])
    if (oh, ow) == (h, w):
        return img
    if interpolation == 'nearest':
        ys = np.clip(np.round(np.arange(oh) * h / oh).astype(int), 0, h - 1)
        xs = np.clip(np.round(np.arange(ow) * w / ow).astype(int), 0, w - 1)
        return img[ys][:, xs]
    # bilinear, half-pixel centers
    dt = img.dtype
    fy = (np.arange(oh) + 0.5) * h / oh - 0.5
    fx = (np.arange(ow) + 0.5) * w / ow - 0.5
    y0 = np.clip(np.floor(fy).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(fx).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(fy - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(fx - x0, 0.0, 1.0)[None, :, None]
    im = img.astype(np.float32)
    top = im[y0][:, x0] * (1 - wx) + im[y0][:, x1] * wx
    bot = im[y1][:, x0] * (1 - wx) + im[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    if np.issubdtype(dt, np.integer):
        out = np.clip(np.round(out), 0, np.iinfo(dt).max).astype(dt)
    return out


def crop(img, top, left, height, width):
    img = _as_hwc(img)
    return img[top:top + height, left:left + width]


def center_crop(img, output_size):
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    img = _as_hwc(img)
    h, w = img.shape[:2]
    th, tw = output_size
    top = int(round((h - th) / 2.0))
    left = int(round((w - tw) / 2.0))
    return crop(img, top, left, th, tw)


def hflip(img):
    return _as_hwc(img)[:, ::-1]


def vflip(img):
    return _as_hwc(img)[::-1]


def pad(img, padding, fill=0, padding_mode='constant'):
    img = _as_hwc(img)
    if isinstance(padding, numbers.Number):
        pl = pr = pt = pb = int(padding)
    elif len(padding) == 2:
        pl, pt = padding
        pr, pb = padding
    else:
        pl, pt, pr, pb = padding
    pads = [(pt, pb), (pl, pr), (0, 0)]
    if padding_mode == 'constant':
        return np.pad(img, pads, mode='constant', constant_values=fill)
    mode = {'edge': 'edge', 'reflect': 'reflect',
            'symmetric': 'symmetric'}[padding_mode]
    return np.pad(img, pads, mode=mode)


def rotate(img, angle, interpolation='nearest', expand=False,
           center=None, fill=0):
    """Rotate counter-clockwise by `angle` degrees (inverse-map
    sampling, 'nearest' or 'bilinear')."""
    if interpolation not in ('nearest', 'bilinear'):
        raise ValueError(
            f"rotate: unsupported interpolation '{interpolation}' "
            "(use 'nearest' or 'bilinear')")
    img = _as_hwc(img)
    h, w = img.shape[:2]
    rad = np.deg2rad(angle)
    cos, sin = np.cos(rad), np.sin(rad)
    if expand:
        ow = int(np.ceil(abs(w * cos) + abs(h * sin)))
        oh = int(np.ceil(abs(h * cos) + abs(w * sin)))
    else:
        ow, oh = w, h
    cy, cx = ((h - 1) / 2.0, (w - 1) / 2.0) if center is None \
        else (center[1], center[0])
    ocy, ocx = (oh - 1) / 2.0, (ow - 1) / 2.0
    yy, xx = np.meshgrid(np.arange(oh), np.arange(ow), indexing='ij')
    dy, dx = yy - ocy, xx - ocx
    src_x = cos * dx - sin * dy + cx
    src_y = sin * dx + cos * dy + cy
    out = np.full((oh, ow, img.shape[2]), fill, dtype=img.dtype)
    if interpolation == 'nearest':
        sx = np.round(src_x).astype(int)
        sy = np.round(src_y).astype(int)
        valid = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
        out[valid] = img[sy[valid], sx[valid]]
        return out
    # bilinear: blend the 4 neighbours of the (fractional) source point
    x0 = np.floor(src_x).astype(int)
    y0 = np.floor(src_y).astype(int)
    fx = (src_x - x0)[..., None]
    fy = (src_y - y0)[..., None]
    valid = (src_x >= 0) & (src_x <= w - 1) & \
            (src_y >= 0) & (src_y <= h - 1)
    x0c = np.clip(x0, 0, w - 1)
    y0c = np.clip(y0, 0, h - 1)
    x1c = np.clip(x0 + 1, 0, w - 1)
    y1c = np.clip(y0 + 1, 0, h - 1)
    f = img.astype(np.float64)
    top = f[y0c, x0c] * (1 - fx) + f[y0c, x1c] * fx
    bot = f[y1c, x0c] * (1 - fx) + f[y1c, x1c] * fx
    blend = top * (1 - fy) + bot * fy
    if np.issubdtype(img.dtype, np.integer):
        blend = np.round(blend)
    out[valid] = blend[valid].astype(img.dtype)
    return out


def to_grayscale(img, num_output_channels=1):
    img = _as_hwc(img)
    if img.shape[2] == 1:
        gray = img.astype(np.float32)[:, :, 0]
    else:
        gray = (0.299 * img[:, :, 0] + 0.587 * img[:, :, 1]
                + 0.114 * img[:, :, 2]).astype(np.float32)
    if np.issubdtype(img.dtype, np.integer):
        gray = np.clip(np.round(gray), 0, 255).astype(img.dtype)
    else:
        gray = gray.astype(img.dtype)
    return np.repeat(gray[:, :, None], num_output_channels, axis=2)


def normalize(img, mean, std, data_format='CHW', to_rgb=False):
    img = np.asarray(img, dtype=np.float32)
    mean = np.asarray(mean, dtype=np.float32)
    std = np.asarray(std, dtype=np.float32)
    if data_format.upper() == 'CHW':
        mean = mean.reshape(-1, 1, 1)
        std = std.reshape(-1, 1, 1)
    return (img - mean) / std


def _blend(img1, img2, ratio):
    dt = img1.dtype
    out = img1.astype(np.float32) * ratio + img2.astype(np.float32) \
        * (1.0 - ratio)
    if np.issubdtype(dt, np.integer):
        return np.clip(out, 0, 255).astype(dt)
    return out.astype(dt)


def adjust_brightness(img, brightness_factor):
    img = _as_hwc(img)
    return _blend(img, np.zeros_like(img), brightness_factor)


def adjust_contrast(img, contrast_factor):
    img = _as_hwc(img)
    mean = to_grayscale(img).astype(np.float32).mean()
    return _blend(img, np.full_like(img, mean.astype(img.dtype)
                  if np.issubdtype(img.dtype, np.integer) else mean),
                  contrast_factor)


def adjust_saturation(img, saturation_factor):
    img = _as_hwc(img)
    gray = to_grayscale(img, num_output_channels=img.shape[2])
    return _blend(img, gray, saturation_factor)


def adjust_hue(img, hue_factor):
    """Shift hue by hue_factor (in [-0.5, 0.5]) via HSV round-trip."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError('hue_factor must be in [-0.5, 0.5]')
    img = _as_hwc(img)
    if img.shape[2] < 3:
        return img  # hue is undefined for grayscale
    dt = img.dtype
    f = img.astype(np.float32)
    if np.issubdtype(dt, np.integer):
        f = f / 255.0
    r, g, b = f[:, :, 0], f[:, :, 1], f[:, :, 2]
    maxc = f.max(axis=2)
    minc = f.min(axis=2)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    dz = np.maximum(delta, 1e-12)
    hr = np.where((maxc == r), ((g - b) / dz) % 6.0, 0.0)
    hg = np.where((maxc == g) & (maxc != r), (b - r) / dz + 2.0, 0.0)
    hb = np.where((maxc == b) & (maxc != r) & (maxc != g),
                  (r - g) / dz + 4.0, 0.0)
    hcomb = ((hr + hg + hb) / 6.0) % 1.0
    hcomb = (hcomb + hue_factor) % 1.0
    i = np.floor(hcomb * 6.0)
    frac = hcomb * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * frac)
    t = v * (1.0 - s * (1.0 - frac))
    i = i.astype(int) % 6
    r2 = np.choose(i, [v, q, p, p, t, v])
    g2 = np.choose(i, [t, v, v, q, p, p])
    b2 = np.choose(i, [p, p, t, v, v, q])
    out = np.stack([r2, g2, b2], axis=2)
    if np.issubdtype(dt, np.integer):
        out = np.clip(np.round(out * 255.0), 0, 255).astype(dt)
    else:
        out = out.astype(dt)
    return out
