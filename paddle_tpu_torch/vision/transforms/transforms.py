"""Composable image transforms (counterpart of
``paddle_tpu/vision/transforms/transforms.py``, a copy of its numpy
code; Paddle's own is python/paddle/vision/transforms/transforms.py:38,
same __all__).  Each transform is a callable over numpy HWC images;
randomness uses stdlib `random`, which paddle_tpu_torch.seed reseeds as
the reference's seed does, so augmentation pipelines are reproducible
from the framework seed and draw what the reference draws.
"""
import numbers
import random

import numpy as np

from . import functional as F

__all__ = ['BaseTransform', 'Compose', 'Resize', 'RandomResizedCrop',
           'CenterCrop', 'RandomHorizontalFlip', 'RandomVerticalFlip',
           'Transpose', 'Normalize', 'BrightnessTransform',
           'SaturationTransform', 'ContrastTransform', 'HueTransform',
           'ColorJitter', 'RandomCrop', 'Pad', 'RandomRotation',
           'Grayscale', 'ToTensor']


def _pair(x):
    if isinstance(x, numbers.Number):
        return (int(x), int(x))
    return tuple(int(v) for v in x)


class BaseTransform:
    """Apply `_apply_image` to the image (and leave labels alone when the
    input is an (img, label) tuple — keys-based dispatch like the ref)."""

    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, inputs):
        if isinstance(inputs, tuple) and self.keys is not None:
            out = []
            for key, x in zip(self.keys, inputs):
                out.append(self._apply_image(x) if key == 'image' else x)
            return tuple(out)
        return self._apply_image(inputs)

    def _apply_image(self, img):
        raise NotImplementedError


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data

    def __repr__(self):
        inner = ', '.join(repr(t.__class__.__name__)
                          for t in self.transforms)
        return f'Compose([{inner}])'


class Resize(BaseTransform):
    def __init__(self, size, interpolation='bilinear', keys=None):
        super().__init__(keys)
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return F.resize(img, self.size, self.interpolation)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3. / 4, 4. / 3),
                 interpolation='bilinear', keys=None):
        super().__init__(keys)
        self.size = _pair(size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _get_param(self, img):
        h, w = np.asarray(img).shape[:2]
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            log_ratio = (np.log(self.ratio[0]), np.log(self.ratio[1]))
            ar = np.exp(random.uniform(*log_ratio))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                top = random.randint(0, h - ch)
                left = random.randint(0, w - cw)
                return top, left, ch, cw
        # central fallback
        ch, cw = min(h, w), min(h, w)
        return (h - ch) // 2, (w - cw) // 2, ch, cw

    def _apply_image(self, img):
        top, left, ch, cw = self._get_param(img)
        img = F.crop(img, top, left, ch, cw)
        return F.resize(img, self.size, self.interpolation)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = _pair(size)

    def _apply_image(self, img):
        return F.center_crop(img, self.size)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        return F.hflip(img) if random.random() < self.prob else img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        return F.vflip(img) if random.random() < self.prob else img


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[:, :, None]
        return np.transpose(img, self.order)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format='CHW', to_rgb=False,
                 keys=None):
        super().__init__(keys)
        if isinstance(mean, numbers.Number):
            mean = [mean, mean, mean]
        if isinstance(std, numbers.Number):
            std = [std, std, std]
        self.mean = mean
        self.std = std
        self.data_format = data_format

    def _apply_image(self, img):
        return F.normalize(img, self.mean, self.std, self.data_format)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        factor = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return F.adjust_brightness(img, factor)


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        if value < 0:
            raise ValueError('contrast value must be non-negative')
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        factor = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return F.adjust_contrast(img, factor)


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        factor = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return F.adjust_saturation(img, factor)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        if not 0 <= value <= 0.5:
            raise ValueError('hue value must be in [0, 0.5]')
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        factor = random.uniform(-self.value, self.value)
        return F.adjust_hue(img, factor)


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        super().__init__(keys)
        self.transforms = [BrightnessTransform(brightness),
                           ContrastTransform(contrast),
                           SaturationTransform(saturation),
                           HueTransform(hue)]

    def _apply_image(self, img):
        order = list(range(4))
        random.shuffle(order)
        for i in order:
            img = self.transforms[i]._apply_image(img)
        return img


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode='constant', keys=None):
        super().__init__(keys)
        self.size = _pair(size)
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        if self.padding is not None:
            img = F.pad(img, self.padding, self.fill, self.padding_mode)
        img = np.asarray(img)
        h, w = img.shape[:2]
        th, tw = self.size
        if self.pad_if_needed and w < tw:
            img = F.pad(img, (tw - w, 0), self.fill, self.padding_mode)
        if self.pad_if_needed and h < th:
            img = F.pad(img, (0, th - h), self.fill, self.padding_mode)
        h, w = np.asarray(img).shape[:2]
        if h == th and w == tw:
            return img
        top = random.randint(0, h - th)
        left = random.randint(0, w - tw)
        return F.crop(img, top, left, th, tw)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode='constant', keys=None):
        super().__init__(keys)
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        return F.pad(img, self.padding, self.fill, self.padding_mode)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation='nearest', expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            if degrees < 0:
                raise ValueError('degrees must be non-negative')
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.interpolation = interpolation
        self.expand = expand
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        angle = random.uniform(*self.degrees)
        return F.rotate(img, angle, self.interpolation, self.expand,
                        self.center, self.fill)


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return F.to_grayscale(img, self.num_output_channels)


class ToTensor(BaseTransform):
    def __init__(self, data_format='CHW', keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        return F.to_tensor(img, self.data_format)
