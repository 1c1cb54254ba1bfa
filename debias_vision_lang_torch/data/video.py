"""Video ingest for the Frozen-in-Time family: the port's own copy of
``debias_vision_lang_tpu/data/video.py``.

Videos are frame directories (``<root>/<video_id>/frame_*.png``, sorted in
natural order, so unpadded ``frame_2`` comes before ``frame_10``) or
animated GIF / WebP files, both decoded by PIL.  A labels CSV
(``file,gender,race,age``, FairFace's label vocabulary) makes such a corpus
measurable with ``measure_bias(..., opts={"dataset": "video"})``: the
``HostLoader`` stages [T, H, W, 3] per video, so batches are
[B, T, H, W, 3], and the device preprocess maps over the frames.
"""

from __future__ import annotations

import os
import re
from typing import Callable, Optional, Union

import numpy as np
import pandas as pd

from .datasets import IATDataset


def _frame_key(name: str):
    """Natural-number sort key: ffmpeg's unpadded %d frame numbers keep
    their temporal order."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name)]


def load_frames(path: str, num_frames: int) -> np.ndarray:
    """``num_frames`` frames sampled uniformly (``np.linspace(0, n - 1,
    num_frames).astype(int)``, so fewer frames repeat) from a frame
    directory or an animated image -> uint8 [T, H, W, 3]."""
    from PIL import Image

    if os.path.isdir(path):
        files = sorted((f for f in os.listdir(path)
                        if f.lower().endswith((".jpg", ".jpeg", ".png"))), key=_frame_key)
        if not files:
            raise FileNotFoundError(f"no frames in {path}")
        idx = np.linspace(0, len(files) - 1, num_frames).astype(int)
        frames = []
        for i in idx:
            with Image.open(os.path.join(path, files[i])) as im:
                frames.append(np.asarray(im.convert("RGB")))
        return np.stack(frames)
    with Image.open(path) as im:  # an animated image (GIF / WebP)
        idx = np.linspace(0, getattr(im, "n_frames", 1) - 1, num_frames).astype(int)
        frames = []
        for i in idx:
            im.seek(int(i))
            frames.append(np.asarray(im.convert("RGB")))
        return np.stack(frames)


class VideoDataset(IATDataset):
    """Attribute-labeled videos, with FairFace's label encodings."""

    RACE_ENCODING = {
        "White": 0, "Southeast Asian": 1, "Middle Eastern": 2, "Black": 3,
        "Indian": 4, "Latino_Hispanic": 5, "East Asian": 6,
    }

    def __init__(self, data_path: os.PathLike, iat_type: Optional[str] = None,
                 csv_name: str = "labels.csv", num_frames: int = 4,
                 _n_samples: Union[int, float, None] = None,
                 transforms: Optional[Callable] = None, equal_split: bool = False):
        self.data_path = str(data_path)
        self.num_frames = num_frames
        self._transforms = (lambda x: x) if transforms is None else transforms
        self.labels = pd.read_csv(os.path.join(self.data_path, csv_name),
                                  keep_default_na=False)
        self.labels.sort_values("file", inplace=True)
        # the shared seeded subsample and balance (float fractions too);
        # balancing needs a gender column
        self._subsample_and_balance(
            _n_samples, equal_split and "gender" in self.labels.columns)
        self._paths = [os.path.join(self.data_path, f) for f in self.labels["file"]]
        self.iat_type = iat_type
        self.iat_labels, self.n_iat_classes = self.gen_labels(iat_type)

    def load_image(self, index: int) -> np.ndarray:
        """The loader's interface: one sample is [T, H, W, 3] uint8 frames."""
        return self._transforms(load_frames(self._paths[index], self.num_frames))

    load_video = load_image
