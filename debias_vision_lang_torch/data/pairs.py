"""Image-caption pair dataset for the contrastive term of debias training.

Counterpart of ``debias_vision_lang_tpu/data/pairs.py`` (whose PIL branch
imports the jax half of preprocess; this copy uses the port's host
preprocess): a directory of images plus a CSV with ``file`` and ``caption``
columns (flickr30k, COCO exports, any custom corpus).
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import pandas as pd

from ..vision.preprocess import center_crop_slice, resize_output_size


class ImageCaptionPairs:
    """CSV-backed (file, caption) pairs; images decoded on demand, each
    short-side resized (bicubic) and center-cropped to ``image_size``."""

    def __init__(self, data_path: os.PathLike, csv_name: str = "captions.csv",
                 images_subdir: str = "images", _n_samples: Optional[int] = None,
                 image_size: Optional[int] = 224):
        self.data_path = str(data_path)
        csv_path = os.path.join(self.data_path, csv_name)
        self.captions = pd.read_csv(csv_path, keep_default_na=False)
        if not {"file", "caption"} <= set(self.captions.columns):
            raise ValueError(f"{csv_path} must have 'file' and 'caption' columns")
        if _n_samples is not None:
            self.captions = self.captions.iloc[:_n_samples]
        self._img_dir = os.path.join(self.data_path, images_subdir)
        self.image_size = image_size

    def __len__(self) -> int:
        return len(self.captions)

    def _path(self, index: int) -> str:
        return os.path.join(self._img_dir, self.captions.iloc[index]["file"])

    def load_image(self, index: int) -> np.ndarray:
        if self.image_size is not None:
            from .. import native

            if native.available():
                out, ok = native.ingest_batch_files_u8([self._path(index)],
                                                       self.image_size)
                if ok[0]:
                    return out[0]
        return self._load_image_pil(index)

    def _load_image_pil(self, index: int) -> np.ndarray:
        from PIL import Image

        with Image.open(self._path(index)) as im:
            if im.mode != "RGB":
                im = im.convert("RGB")
            if self.image_size is None:
                return np.asarray(im)
            n = self.image_size
            rh, rw = resize_output_size(im.height, im.width, n)
            if (rh, rw) != (im.height, im.width):
                im = im.resize((rw, rh), Image.BICUBIC)
            arr = np.asarray(im)
            return arr[center_crop_slice(rh, n), center_crop_slice(rw, n)]

    def caption(self, index: int) -> str:
        return str(self.captions.iloc[index]["caption"])

    def index_batches(self, batch_size: int,
                      rng: Optional[np.random.Generator] = None,
                      drop_remainder: bool = True) -> Iterator[np.ndarray]:
        """One pass of row-index batches in shuffled order (one rng draw per
        pass); ``load_batch`` decodes them."""
        order = np.arange(len(self))
        if rng is not None:
            rng.shuffle(order)
        for s in range(0, len(order), batch_size):
            idx = order[s: s + batch_size]
            if drop_remainder and len(idx) < batch_size:
                return
            yield idx

    def load_batch(self, idx: np.ndarray, tokenizer: Callable
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Decode + tokenize the given rows: (images_u8 [B,H,W,3], tokens)."""
        from .. import native

        if self.image_size is not None and native.available():
            paths = [self._path(int(i)) for i in idx]
            images, ok = native.ingest_batch_files_u8(paths, self.image_size)
            for j in np.nonzero(~ok)[0]:  # files the native decoder rejects
                images[j] = self._load_image_pil(int(idx[j]))
        else:
            images = np.stack([self.load_image(int(i)) for i in idx])
        tokens = np.asarray(tokenizer([self.caption(int(i)) for i in idx]))
        return images, tokens
