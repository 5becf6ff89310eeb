"""Vision transforms of the port (counterpart of
`paddle_tpu/vision/transforms/__init__.py`; ref
`python/paddle/vision/transforms/`) on numpy HWC images.

Every random draw comes from the stdlib ``random`` module, in the JAX
package's order, so ``random.seed`` gives both packages the same crops,
flips and jitters. `Resize` takes PIL's C path for uint8 images when PIL
imports, else the numpy half-pixel bilinear, as the JAX package does.
`ToTensor` makes a Tensor on the current device.
"""
from __future__ import annotations

import numbers
import random

import numpy as np

from paddle_tpu_torch.core.tensor import Tensor


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class BaseTransform:
    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, img):
        return self._apply_image(img)

    def _apply_image(self, img):
        raise NotImplementedError


def _as_hwc(img):
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        arr = _as_hwc(img).astype(np.float32)
        if arr.dtype == np.uint8 or arr.max() > 1.5:
            arr = arr / 255.0
        if self.data_format == "CHW":
            arr = arr.transpose(2, 0, 1)
        return Tensor(arr.astype(np.float32))


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        super().__init__(keys)
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        if isinstance(img, Tensor):
            arr = img.numpy()
        else:
            arr = np.asarray(img, np.float32)
        if self.data_format == "CHW":
            m = self.mean.reshape(-1, 1, 1)
            s = self.std.reshape(-1, 1, 1)
        else:
            m = self.mean
            s = self.std
        out = (arr - m) / s
        return Tensor(out.astype(np.float32)) if isinstance(img, Tensor) else \
            out.astype(np.float32)


def _resize_bilinear_np(arr, th, tw):
    """Vectorized half-pixel bilinear resample on numpy (HWC)."""
    h, w = arr.shape[:2]
    a = arr.astype(np.float32)
    ys = (np.arange(th, dtype=np.float32) + 0.5) * (h / th) - 0.5
    xs = (np.arange(tw, dtype=np.float32) + 0.5) * (w / tw) - 0.5
    y0 = np.clip(np.floor(ys), 0, h - 1).astype(np.int64)
    x0 = np.clip(np.floor(xs), 0, w - 1).astype(np.int64)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    top = a[y0][:, x0] * (1 - wx) + a[y0][:, x1] * wx
    bot = a[y1][:, x0] * (1 - wx) + a[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        # host-side bilinear: the input pipeline must never bounce per-sample
        # work through the accelerator (PIL's C path for uint8, vectorized
        # numpy otherwise)
        arr = _as_hwc(img)
        th, tw = self.size
        if arr.dtype == np.uint8:
            try:
                from PIL import Image
                if arr.shape[2] in (1, 3, 4):
                    mode_arr = arr[:, :, 0] if arr.shape[2] == 1 else arr
                    out = np.asarray(Image.fromarray(mode_arr).resize(
                        (tw, th), Image.BILINEAR))
                    if out.ndim == 2:
                        out = out[:, :, None]
                    return out
            except Exception:
                pass
        return _resize_bilinear_np(arr, th, tw).astype(arr.dtype)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        arr = _as_hwc(img)
        h, w = arr.shape[:2]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return arr[i:i + th, j:j + tw]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def _apply_image(self, img):
        arr = _as_hwc(img)
        if self.padding:
            p = self.padding if isinstance(self.padding, int) else self.padding[0]
            arr = np.pad(arr, ((p, p), (p, p), (0, 0)))
        h, w = arr.shape[:2]
        th, tw = self.size
        i = random.randint(0, max(h - th, 0))
        j = random.randint(0, max(w - tw, 0))
        return arr[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return _as_hwc(img)[:, ::-1]
        return _as_hwc(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return _as_hwc(img)[::-1]
        return _as_hwc(img)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio

    def _apply_image(self, img):
        arr = _as_hwc(img)
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = random.uniform(*self.scale) * area
            ar = random.uniform(*self.ratio)
            tw = int(round(np.sqrt(target_area * ar)))
            th = int(round(np.sqrt(target_area / ar)))
            if 0 < tw <= w and 0 < th <= h:
                i = random.randint(0, h - th)
                j = random.randint(0, w - tw)
                crop = arr[i:i + th, j:j + tw]
                return Resize(self.size)._apply_image(crop)
        return Resize(self.size)._apply_image(CenterCrop(
            min(h, w))._apply_image(arr))


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        return _as_hwc(img).transpose(self.order)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        arr = _as_hwc(img).astype(np.float32)
        alpha = 1 + random.uniform(-self.value, self.value)
        return np.clip(arr * alpha, 0, 255).astype(np.uint8)


def to_tensor(pic, data_format="CHW"):
    return ToTensor(data_format)(pic)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


def hflip(img):
    return _as_hwc(img)[:, ::-1]


def vflip(img):
    return _as_hwc(img)[::-1]


def center_crop(img, output_size):
    return CenterCrop(output_size)(img)


def crop(img, top, left, height, width):
    return _as_hwc(img)[top:top + height, left:left + width]


def pad(img, padding, fill=0, padding_mode="constant"):
    arr = _as_hwc(img)
    if isinstance(padding, int):
        padding = (padding, padding, padding, padding)
    l, t, r, b = padding
    return np.pad(arr, ((t, b), (l, r), (0, 0)), constant_values=fill)


def _rgb_to_hsv(rgb):
    """Vectorized RGB[0,1] -> HSV[0,1] (matches colorsys semantics)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = np.max(rgb, axis=-1)
    minc = np.min(rgb, axis=-1)
    v = maxc
    rng = maxc - minc
    s_ = np.where(maxc > 0, rng / np.maximum(maxc, 1e-12), 0.0)
    rngs = np.maximum(rng, 1e-12)
    rc = (maxc - r) / rngs
    gc = (maxc - g) / rngs
    bc = (maxc - b) / rngs
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(rng > 0, (h / 6.0) % 1.0, 0.0)
    return np.stack([h, s_, v], axis=-1)


def _hsv_to_rgb(hsv):
    """Vectorized HSV[0,1] -> RGB[0,1]."""
    h, s_, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s_)
    q = v * (1.0 - s_ * f)
    t = v * (1.0 - s_ * (1.0 - f))
    i = i.astype(np.int64) % 6
    choices = np.stack([
        np.stack([v, t, p], -1), np.stack([q, v, p], -1),
        np.stack([p, v, t], -1), np.stack([p, q, v], -1),
        np.stack([t, p, v], -1), np.stack([v, p, q], -1)], 0)
    return np.take_along_axis(choices, i[None, ..., None], axis=0)[0]


def adjust_brightness(img, brightness_factor):
    """Scale pixel intensities (ref functional.adjust_brightness)."""
    arr = _as_hwc(img).astype(np.float32)
    return np.clip(arr * brightness_factor, 0, 255).astype(np.uint8)


def adjust_contrast(img, contrast_factor):
    """Blend with the mean intensity (ref functional.adjust_contrast)."""
    arr = _as_hwc(img).astype(np.float32)
    mean = arr.mean()
    return np.clip(mean + contrast_factor * (arr - mean), 0, 255).astype(np.uint8)


def adjust_saturation(img, saturation_factor):
    """Blend with the grayscale image (ref functional.adjust_saturation)."""
    arr = _as_hwc(img).astype(np.float32)
    gray = arr @ np.asarray([0.299, 0.587, 0.114], np.float32) \
        if arr.shape[-1] == 3 else arr[..., 0]
    gray = gray[..., None]
    return np.clip(gray + saturation_factor * (arr - gray), 0, 255).astype(np.uint8)


def adjust_hue(img, hue_factor):
    """Rotate hue (ref functional.adjust_hue); hue_factor in [-0.5, 0.5].
    Vectorized numpy HSV round-trip (the data-loading hot path)."""
    arr = _as_hwc(img)
    if arr.shape[-1] != 3:
        return arr
    hsv = _rgb_to_hsv(arr.astype(np.float32) / 255.0)
    hsv[..., 0] = (hsv[..., 0] + hue_factor) % 1.0
    rgb = _hsv_to_rgb(hsv)
    return np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)


def to_grayscale(img, num_output_channels=1):
    arr = _as_hwc(img).astype(np.float32)
    gray = arr @ np.asarray([0.299, 0.587, 0.114], np.float32) \
        if arr.shape[-1] == 3 else arr[..., 0]
    out = gray[..., None]
    if num_output_channels == 3:
        out = np.repeat(out, 3, axis=-1)
    return np.clip(out, 0, 255).astype(np.uint8)


def erase(img, i, j, h, w, v, inplace=False):
    """Erase a rectangle (ref functional.erase)."""
    arr = _as_hwc(img)
    if not inplace:
        arr = arr.copy()
    arr[i:i + h, j:j + w] = v
    return arr


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    """Rotate an HWC image by `angle` degrees counter-clockwise
    (ref functional.rotate); nearest-neighbor sampling. With ``expand`` the
    output grows to hold the whole rotated image."""
    arr = _as_hwc(img)
    h, w = arr.shape[:2]
    cy, cx = ((h - 1) / 2.0, (w - 1) / 2.0) if center is None else \
        (center[1], center[0])
    rad = np.deg2rad(angle)
    cos_a, sin_a = np.cos(rad), np.sin(rad)
    if expand:
        oh = int(np.ceil(abs(h * cos_a) + abs(w * sin_a)))
        ow = int(np.ceil(abs(w * cos_a) + abs(h * sin_a)))
        ocy, ocx = (oh - 1) / 2.0, (ow - 1) / 2.0
    else:
        oh, ow, ocy, ocx = h, w, cy, cx
    ys, xs = np.mgrid[0:oh, 0:ow]
    # inverse map: output pixel -> source pixel
    sx = cos_a * (xs - ocx) + sin_a * (ys - ocy) + cx
    sy = -sin_a * (xs - ocx) + cos_a * (ys - ocy) + cy
    sxi = np.round(sx).astype(np.int64)
    syi = np.round(sy).astype(np.int64)
    valid = (sxi >= 0) & (sxi < w) & (syi >= 0) & (syi < h)
    out = np.full((oh, ow) + arr.shape[2:], fill, dtype=arr.dtype)
    out[valid] = arr[syi[valid], sxi[valid]]
    return out


class ContrastTransform(BaseTransform):
    """Random contrast jitter (ref transforms.py:ContrastTransform)."""

    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        return adjust_contrast(img, 1 + random.uniform(-self.value, self.value))


class SaturationTransform(BaseTransform):
    """Random saturation jitter (ref transforms.py:SaturationTransform)."""

    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        return adjust_saturation(img,
                                 1 + random.uniform(-self.value, self.value))


class HueTransform(BaseTransform):
    """Random hue rotation (ref transforms.py:HueTransform); value in [0, 0.5]."""

    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        return adjust_hue(img, random.uniform(-self.value, self.value))


class ColorJitter(BaseTransform):
    """Random brightness/contrast/saturation/hue (ref transforms.py:ColorJitter)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0, keys=None):
        super().__init__(keys)
        self.ts = []
        if brightness:
            self.ts.append(BrightnessTransform(brightness))
        if contrast:
            self.ts.append(ContrastTransform(contrast))
        if saturation:
            self.ts.append(SaturationTransform(saturation))
        if hue:
            self.ts.append(HueTransform(hue))

    def _apply_image(self, img):
        order = list(self.ts)
        random.shuffle(order)
        for t in order:
            img = t(img)
        return img


class Grayscale(BaseTransform):
    """RGB -> grayscale with 1 or 3 output channels (ref transforms.py:Grayscale)."""

    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.num_output_channels)


class RandomRotation(BaseTransform):
    """Random rotation by an angle in degrees (ref transforms.py:RandomRotation).
    Nearest-neighbor resampling on the numpy grid (no PIL dependency in the
    hot path)."""

    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.interpolation = interpolation
        self.expand = expand
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        angle = random.uniform(*self.degrees)
        return rotate(img, angle, interpolation=self.interpolation,
                      expand=self.expand, center=self.center, fill=self.fill)


class RandomErasing(BaseTransform):
    """Random cutout rectangle (ref transforms.py:RandomErasing)."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3), value=0,
                 inplace=False, keys=None):
        super().__init__(keys)
        self.prob, self.scale, self.ratio, self.value = prob, scale, ratio, value
        self.inplace = inplace

    def _apply_image(self, img):
        arr = _as_hwc(img)
        if random.random() > self.prob:
            return arr
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            ar = random.uniform(*self.ratio)
            eh = int(round((target * ar) ** 0.5))
            ew = int(round((target / ar) ** 0.5))
            if eh < h and ew < w:
                top = random.randint(0, h - eh)
                left = random.randint(0, w - ew)
                return erase(arr, top, left, eh, ew, self.value,
                             inplace=self.inplace)
        return arr
