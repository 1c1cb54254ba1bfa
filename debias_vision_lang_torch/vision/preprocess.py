"""Image preprocess: bicubic resize -> center crop -> normalize.

Counterpart of ``debias_vision_lang_tpu/vision/preprocess.py``, which
imports jax at module top; this copy carries the numpy host half unchanged
and the device half in torch.

Reference chain (torchvision + PIL): Resize(n_px, BICUBIC) with the short
side to n_px, CenterCrop(n_px), ToTensor, Normalize(CLIP mean/std).

  * host (numpy, bit-exact vs PIL): PIL's uint8 resample quantizes the
    normalised bicubic coefficients to int32 fixed point (22 fractional
    bits) and emits ``clip8((sum + 2^21) >> 22)`` per pass, horizontal
    then vertical; ``resize_bicubic_pil_exact`` replays that arithmetic.
  * device (torch, ``preprocess_batch``): float32 resize as two matmuls,
    within 2 LSB of PIL.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _bicubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """PIL's bicubic filter (Keys kernel, a = -0.5), support 2."""
    x = np.abs(x)
    return np.where(
        x < 1.0,
        ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0),
    )


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] float resampling matrix on PIL's grid."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    inv = 1.0 / filterscale
    w = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        xs = np.arange(xmin, xmax)
        k = _bicubic((xs - center + 0.5) * inv)
        w[xx, xmin:xmax] = k / k.sum()
    return w.astype(np.float32)


def resize_output_size(h: int, w: int, n_px: int) -> Tuple[int, int]:
    """torchvision Resize(int): short side -> n_px, the long side truncates."""
    if h <= w:
        if h == n_px:
            return h, w
        return n_px, max(int(n_px * w / h), 1)
    if w == n_px:
        return h, w
    return max(int(n_px * h / w), 1), n_px


_PIL_PRECISION_BITS = 22


@functools.lru_cache(maxsize=64)
def resize_weights_pil_fixed(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] int32 matrix of PIL's quantized bicubic coeffs.
    Scalar loops on purpose: PIL sums the normalizer sequentially in
    double, and a pairwise sum can move the quantized coefficient."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    inv = 1.0 / filterscale
    one = 1 << _PIL_PRECISION_BITS
    m = np.zeros((out_size, in_size), np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        ks = [float(_bicubic(np.float64((x + xmin - center + 0.5) * inv)))
              for x in range(xmax - xmin)]
        ww = 0.0
        for k in ks:
            ww += k
        for i, k in enumerate(ks):
            if ww != 0.0:
                k = k / ww
            m[xx, xmin + i] = int(k * one + 0.5) if k >= 0 else int(k * one - 0.5)
    return m


def _clip8(ss: np.ndarray) -> np.ndarray:
    ss = np.clip(ss, 0, (1 << 30) - 1)
    return (ss >> _PIL_PRECISION_BITS).astype(np.uint8)


def resize_bicubic_pil_exact(arr_u8: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bit-exact PIL BICUBIC resize of a uint8 [H, W, C] array."""
    h, w, _ = arr_u8.shape
    half = 1 << (_PIL_PRECISION_BITS - 1)
    x = arr_u8.astype(np.int64)
    if w != out_w:
        m = resize_weights_pil_fixed(w, out_w).astype(np.int64)
        x = _clip8(np.einsum("ow,hwc->hoc", m, x) + half).astype(np.int64)
    if h != out_h:
        m = resize_weights_pil_fixed(h, out_h).astype(np.int64)
        x = _clip8(np.einsum("oh,hwc->owc", m, x) + half).astype(np.int64)
    return x.astype(np.uint8)


def center_crop_slice(size: int, crop: int) -> slice:
    """torchvision CenterCrop offset: round((size - crop) / 2)."""
    top = int(round((size - crop) / 2.0))
    return slice(top, top + crop)


def _pad_amounts(rh: int, rw: int, n_px: int):
    """torchvision CenterCrop pads a smaller image, extra pixel right/bottom."""
    ph, pw = max(n_px - rh, 0), max(n_px - rw, 0)
    return (ph // 2, (ph + 1) // 2), (pw // 2, (pw + 1) // 2)


def resize_crop_u8(arr_u8: np.ndarray, n_px: int = 224) -> np.ndarray:
    """Resize(n_px, BICUBIC) -> CenterCrop(n_px), bit-exact vs PIL:
    uint8 [H, W, 3] -> uint8 [n_px, n_px, 3]."""
    h, w, _ = arr_u8.shape
    rh, rw = resize_output_size(h, w, n_px)
    x = resize_bicubic_pil_exact(arr_u8, rh, rw)
    if rh < n_px or rw < n_px:
        x = np.pad(x, (*_pad_amounts(rh, rw, n_px), (0, 0)))
        rh, rw = x.shape[0], x.shape[1]
    return x[center_crop_slice(rh, n_px), center_crop_slice(rw, n_px), :]


def preprocess_host_exact(arr_u8: np.ndarray, n_px: int = 224,
                          mean=CLIP_MEAN, std=CLIP_STD) -> np.ndarray:
    """Bit-exact host replica of the reference transform chain:
    uint8 [H, W, 3] -> float32 [n_px, n_px, 3] (HWC), torchvision op order."""
    x = resize_crop_u8(arr_u8, n_px)
    out = x.astype(np.float32) / np.float32(255.0)
    out = out - np.asarray(mean, np.float32)
    return out / np.asarray(std, np.float32)


def patchify_u8(arr_u8: np.ndarray, patch: int) -> np.ndarray:
    """uint8 [B, H, W, 3] (or one [H, W, 3]) -> patch-contiguous staging
    [B, gh*gw, patch*patch*3], the layout ``encode_image_vit_p8`` reads."""
    one = arr_u8.ndim == 3
    if one:
        arr_u8 = arr_u8[None]
    b, h, w, c = arr_u8.shape
    gh, gw = h // patch, w // patch
    out = (arr_u8.reshape(b, gh, patch, gw, patch * c)
           .transpose(0, 1, 3, 2, 4)
           .reshape(b, gh * gw, patch * patch * c))
    out = np.ascontiguousarray(out)
    return out[0] if one else out


def to_rgb_array(img) -> np.ndarray:
    """PIL image / array -> uint8 [H, W, 3]; an ndarray never touches PIL."""
    if isinstance(img, np.ndarray):
        arr = img
    else:
        if img.mode != "RGB":
            img = img.convert("RGB")
        arr = np.asarray(img)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr.astype(np.uint8)


# --- device half (torch) ---------------------------------------------------


def resize_bicubic(images: torch.Tensor, out_h: int, out_w: int,
                   emulate_uint8_rounding: bool = False) -> torch.Tensor:
    """Batched bicubic resize of float32 [B, H, W, C] in [0, 255], horizontal
    pass then vertical; ``emulate_uint8_rounding`` rounds to uint8 after each
    pass as PIL does."""
    _, h, w, _ = images.shape
    x = images
    if w != out_w:
        ww = torch.from_numpy(resize_weights(w, out_w)).to(x.device)
        x = torch.einsum("ow,bhwc->bhoc", ww, x)
        if emulate_uint8_rounding:
            x = torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)
    if h != out_h:
        wh = torch.from_numpy(resize_weights(h, out_h)).to(x.device)
        x = torch.einsum("oh,bhwc->bowc", wh, x)
        if emulate_uint8_rounding:
            x = torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)
    return x


def preprocess_batch(images_u8: torch.Tensor, n_px: int = 224,
                     emulate_uint8_rounding: bool = False,
                     mean=CLIP_MEAN, std=CLIP_STD) -> torch.Tensor:
    """Device preprocess: uint8 [B, H, W, 3] -> normalized float32
    [B, n_px, n_px, 3] (NHWC, the layout the towers take)."""
    _, h, w, _ = images_u8.shape
    x = images_u8.float()
    rh, rw = resize_output_size(h, w, n_px)
    x = resize_bicubic(x, rh, rw, emulate_uint8_rounding)
    if rh < n_px or rw < n_px:
        (pt, pb), (pl, pr) = _pad_amounts(rh, rw, n_px)
        x = torch.nn.functional.pad(x, (0, 0, pl, pr, pt, pb))
        rh, rw = x.shape[1], x.shape[2]
    x = x[:, center_crop_slice(rh, n_px), center_crop_slice(rw, n_px), :]
    m = torch.tensor(mean, dtype=torch.float32, device=x.device) * 255.0
    sd = torch.tensor(std, dtype=torch.float32, device=x.device) * 255.0
    return (x - m) / sd


class Preprocess:
    """Per-image callable (PIL image or uint8 array -> normalized float32
    [n_px, n_px, 3] HWC numpy).  ``emulate_uint8_rounding=True`` (default)
    is the bit-exact host chain; ``False`` runs ``preprocess_batch`` on the
    CPU.  Batched use goes through ``preprocess_batch`` directly."""

    def __init__(self, n_px: int = 224, emulate_uint8_rounding: bool = True,
                 use_native: bool = True, mean=CLIP_MEAN, std=CLIP_STD):
        self.n_px = n_px
        self.emulate_uint8_rounding = emulate_uint8_rounding
        self.use_native = use_native
        self.mean = tuple(mean)
        self.std = tuple(std)

    def __call__(self, img) -> np.ndarray:
        arr = to_rgb_array(img)
        if not self.emulate_uint8_rounding:
            out = preprocess_batch(torch.from_numpy(arr[None]), self.n_px,
                                   False, mean=self.mean, std=self.std)
            return out[0].numpy()
        if self.use_native and (self.mean, self.std) == (CLIP_MEAN, CLIP_STD):
            # the C++ replica of the same arithmetic (it bakes CLIP's stats)
            from .. import native

            if native.available():
                return native.preprocess_u8(arr, self.n_px)
        return preprocess_host_exact(arr, self.n_px, mean=self.mean,
                                     std=self.std)


def build_preprocess(n_px: int = 224, mean=CLIP_MEAN, std=CLIP_STD) -> Preprocess:
    return Preprocess(n_px=n_px, mean=mean, std=std)
