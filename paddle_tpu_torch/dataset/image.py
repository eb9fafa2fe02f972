"""paddle.dataset.image — numpy image helpers of the fluid data stack.

Counterpart of ``paddle_tpu/dataset/image.py``; Paddle's
python/paddle/dataset/image.py (resize_short:173, to_chw:203,
center_crop:229, random_crop:255, left_right_flip:283,
simple_transform:304, load_image:128, batch_images_from_tar:87).  The
reference shells out to cv2; these are pure-numpy equivalents (bilinear
resize) — the input pipeline does augmentation on the host anyway, and
vision.transforms carries the full-featured versions.
"""
import numpy as np

__all__ = ['resize_short', 'to_chw', 'center_crop', 'random_crop',
           'left_right_flip', 'simple_transform', 'load_image',
           'load_and_transform']


def _bilinear_resize(im, h, w):
    """HWC (or HW) uint8/float -> bilinear resampled float32."""
    im = np.asarray(im)
    squeeze = im.ndim == 2
    if squeeze:
        im = im[:, :, None]
    H, W, C = im.shape
    ys = (np.arange(h) + 0.5) * H / h - 0.5
    xs = (np.arange(w) + 0.5) * W / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    im = im.astype(np.float32)
    top = im[y0][:, x0] * (1 - wx) + im[y0][:, x1] * wx
    bot = im[y1][:, x0] * (1 - wx) + im[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    return out[:, :, 0] if squeeze else out


def resize_short(im, size):
    """Scale so the SHORT side equals `size` (reference image.py:173)."""
    h, w = im.shape[:2]
    if h < w:
        nh, nw = size, int(round(w * size / h))
    else:
        nh, nw = int(round(h * size / w)), size
    return _bilinear_resize(im, nh, nw)


def to_chw(im, order=(2, 0, 1)):
    """HWC -> CHW (reference image.py:203)."""
    return np.asarray(im).transpose(order)


def center_crop(im, size, is_color=True):
    """Crop the central size x size window (reference image.py:229)."""
    h, w = im.shape[:2]
    hs, ws = (h - size) // 2, (w - size) // 2
    return im[hs:hs + size, ws:ws + size]


def random_crop(im, size, is_color=True):
    """Crop a uniformly random size x size window (reference
    image.py:255)."""
    h, w = im.shape[:2]
    hs = np.random.randint(0, h - size + 1)
    ws = np.random.randint(0, w - size + 1)
    return im[hs:hs + size, ws:ws + size]


def left_right_flip(im, is_color=True):
    """Mirror horizontally (reference image.py:283)."""
    return im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train, is_color=True,
                     mean=None):
    """resize_short → (random|center) crop → maybe flip → CHW → -mean
    (reference image.py:304)."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size)
        if np.random.randint(2) == 0:
            im = left_right_flip(im, is_color)
    else:
        im = center_crop(im, crop_size)
    if im.ndim == 3:
        im = to_chw(im)
    im = im.astype(np.float32)
    if mean is not None:
        mean = np.asarray(mean, np.float32)
        if mean.ndim == 1 and im.ndim == 3:
            mean = mean[:, None, None]
        im = im - mean
    return im


def load_image(file_path, is_color=True):
    """Decode an image file.  PNG/BMP via pure numpy is out of scope —
    uses vision's loader when pillow is available, else raises
    (reference image.py:128 uses cv2)."""
    try:
        from PIL import Image
        with Image.open(file_path) as img:
            img = img.convert('RGB' if is_color else 'L')
            return np.asarray(img)
    except ImportError as e:
        raise RuntimeError(
            'load_image needs pillow in this build; feed arrays '
            'directly or use paddle.vision.datasets') from e


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    return simple_transform(load_image(filename, is_color), resize_size,
                            crop_size, is_train, is_color, mean)
