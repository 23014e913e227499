"""Image preprocessing / augmentation for input pipelines.

Fills the reference's image tooling role (reference:
python/paddle/utils/image_util.py resize/crop/flip/mean +
ImageTransformer; python/paddle/utils/image_multiproc.py multiprocess
pipeline) in TPU-native form: every transform is a pure numpy function
on HWC uint8/float arrays (host-side work — the accelerator only ever
sees the final dense batch), composable with the reader combinators;
`paddle_tpu_torch.data.reader.xmap_readers` supplies the multiprocess fan-out
the reference got from PaddleMP.

Convention: HWC float32 (NHWC batches), channels last — matching the
model zoo. PIL is used only for decode/resize when available.
"""

from __future__ import annotations

import io
import threading
from typing import Optional

import numpy as np


def decode_image(data: bytes, *, color: bool = True) -> np.ndarray:
    """JPEG/PNG bytes -> HWC uint8 (reference: image_util.decode_jpeg)."""
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    img = img.convert("RGB" if color else "L")
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def load_image(path: str, *, color: bool = True) -> np.ndarray:
    """reference: image_util.load_image."""
    with open(path, "rb") as f:
        return decode_image(f.read(), color=color)


def resize_short(img: np.ndarray, size: int) -> np.ndarray:
    """Resize so the SHORT side equals `size`, keeping aspect ratio
    (reference: image_util.resize_image resizes by the short edge)."""
    from PIL import Image

    h, w = img.shape[:2]
    if h <= w:
        nh, nw = size, max(1, round(w * size / h))
    else:
        nh, nw = max(1, round(h * size / w)), size
    squeeze = img.shape[-1] == 1
    pil = Image.fromarray(img[..., 0] if squeeze else img)
    out = np.asarray(pil.resize((nw, nh), Image.BILINEAR))
    return out[..., None] if squeeze else out


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """reference: image_util.crop_img(test=True)."""
    h, w = img.shape[:2]
    if h < size or w < size:
        raise ValueError(f"image {h}x{w} smaller than crop {size}")
    top, left = (h - size) // 2, (w - size) // 2
    return img[top:top + size, left:left + size]


def random_crop(img: np.ndarray, size: int,
                rng: np.random.RandomState) -> np.ndarray:
    """reference: image_util.crop_img(test=False)."""
    h, w = img.shape[:2]
    if h < size or w < size:
        raise ValueError(f"image {h}x{w} smaller than crop {size}")
    top = int(rng.randint(0, h - size + 1))
    left = int(rng.randint(0, w - size + 1))
    return img[top:top + size, left:left + size]


def random_flip(img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Horizontal flip with p=0.5 (reference: image_util.flip, applied
    randomly at train time in preprocess_img)."""
    return img[:, ::-1] if rng.rand() < 0.5 else img


def normalize(img: np.ndarray, mean=None, std=None) -> np.ndarray:
    """uint8 HWC -> float32 in [0,1], then per-channel (x-mean)/std
    (reference: ImageTransformer.set_mean + scale)."""
    was_int = np.issubdtype(np.asarray(img).dtype, np.integer)
    out = np.asarray(img, np.float32)
    if was_int:  # integer pixels are 0..255 by convention
        out = out / 255.0
    if mean is not None:
        out = out - np.asarray(mean, np.float32)
    if std is not None:
        out = out / np.asarray(std, np.float32)
    return out


def oversample(img: np.ndarray, size: int) -> np.ndarray:
    """10-crop eval augmentation: 4 corners + center, each mirrored
    (reference: image_util.oversample). Returns [10, size, size, C]."""
    h, w = img.shape[:2]
    tops, lefts = (0, h - size), (0, w - size)
    crops = []
    for t in tops:
        for l in lefts:
            crops.append(img[t:t + size, l:l + size])
    crops.append(center_crop(img, size))
    out = np.stack(crops + [c[:, ::-1] for c in crops])
    return out


class Transformer:
    """Composable preprocess pipeline (reference:
    image_util.ImageTransformer + preprocess_img): short-side resize →
    crop (random at train / center at eval) → random flip (train) →
    normalize. Deterministic per seed when driven single-threaded;
    under xmap_readers' thread fan-out the draws are LOCK-protected
    (RandomState is not thread-safe) — state stays valid, but the
    assignment of draws to samples then depends on thread timing."""

    def __init__(self, *, resize: Optional[int] = 256, crop: int = 224,
                 is_train: bool = True, mean=None, std=None,
                 seed: int = 0):
        self.resize = resize
        self.crop = crop
        self.is_train = is_train
        self.mean = mean
        self.std = std
        self.rng = np.random.RandomState(seed)
        self._lock = threading.Lock()

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if self.resize:
            img = resize_short(img, self.resize)
        if self.is_train:
            with self._lock:
                img = random_crop(img, self.crop, self.rng)
                img = random_flip(img, self.rng)
        else:
            img = center_crop(img, self.crop)
        return normalize(img, self.mean, self.std)


def transformed_reader(reader, transformer: Transformer,
                       process_num: int = 0, buffer_size: int = 64):
    """Map a (img, label) reader through a Transformer; process_num > 0
    fans the mapping out over threads (reference:
    image_multiproc.PaddleMP's role, via reader.xmap_readers)."""
    from paddle_tpu_torch.data import reader as R

    def mapper(sample):
        img, label = sample
        return transformer(img), label

    if process_num and process_num > 0:
        return R.xmap_readers(mapper, reader, process_num, buffer_size)
    return R.map_readers(mapper, reader)
