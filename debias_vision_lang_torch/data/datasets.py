"""Attribute-labeled face datasets (FairFace, UTKFace) for bias measurement:
the port's own copy of ``debias_vision_lang_tpu/data/datasets.py``, without
the downloads (``download=True`` raises; fetch the data with the JAX
package's ``data/download.py`` and point ``data_path`` at it).

Functional parity with the reference's data layer
(reference: debias_clip/datasets.py) with identical label encodings, CSV
layout, sorting, subsampling and the seeded gender-balancing ``equal_split``
— plus a batch path: instead of a torch DataLoader with worker *processes*
(reference: measuring_bias.py:142), batching happens via a thread-pool
host-ingest loader (data/loader.py) that yields fixed-shape uint8 arrays
ready for the device preprocess.

Divergences from the reference (documented):
  * pandas>=2 compatible (the reference uses removed APIs:
    ``DataFrame.append`` at datasets.py:78, ``count()[0]`` at :71-72).
  * ``iat_type=None`` raises a clear ValueError instead of the reference's
    accidental ``NotImplementedError`` from its always-called gen_labels
    (datasets.py:53,87 → :41-42).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Union

import numpy as np
import pandas as pd

from ..core.config import Dotdict
from ..core.paths import FAIRFACE_DATA_PATH, UTKFACE_DATA_PATH


def _no_download(name: str) -> None:
    raise NotImplementedError(
        f"the port does not download {name}: fetch it with the JAX package's "
        f"data/download.py and pass data_path (or set the dataset's "
        f"DEBIAS_VLT_*_PATH), with download=False")


def _load_rgb(path: str) -> np.ndarray:
    """Decode an image file to uint8 [H, W, 3] RGB.

    Routes through the native C++ decoder (libjpeg/libpng, PIL-bit-exact —
    tests/test_native_ingest.py) when available, PIL otherwise; exotic
    formats the native decoder rejects fall back to PIL too."""
    from .. import native

    if native.available():
        try:
            with open(path, "rb") as f:
                return native.decode_jpeg(f.read())
        except ValueError:
            pass  # not JPEG/PNG — let PIL sort it out
    from PIL import Image

    with Image.open(path) as im:
        if im.mode != "RGB":
            im = im.convert("RGB")
        return np.asarray(im)


class IATDataset:
    """Base: integer label generation for a protected attribute.

    Encodings are identical to the reference (datasets.py:17-19).
    """

    GENDER_ENCODING = {"Female": 1, "Male": 0}
    AGE_ENCODING = {
        "0-2": 0, "3-9": 1, "10-19": 2, "20-29": 3, "30-39": 4,
        "40-49": 5, "50-59": 6, "60-69": 7, "more than 70": 8,
    }
    RACE_ENCODING: dict = {}

    labels: pd.DataFrame

    def _subsample_and_balance(self, _n_samples, equal_split: bool) -> None:
        """Shared float/int ``_n_samples`` truncation + seeded gender
        balancing (random_state=1, male block first — parity with the
        reference, datasets.py:61-78).  Mutates ``self.labels``."""
        if _n_samples is not None:
            if isinstance(_n_samples, float):
                _n_samples = int(len(self.labels) * _n_samples)
            self.labels = self.labels.iloc[:_n_samples]
        if equal_split and len(self.labels):
            males = self.labels.loc[self.labels["gender"] == "Male"]
            females = self.labels.loc[self.labels["gender"] == "Female"]
            n = min(len(males), len(females))
            males = males.sample(n=n, random_state=1)
            females = females.sample(n=n, random_state=1)
            self.labels = pd.concat([males, females], ignore_index=True)

    def gen_labels(self, iat_type: str, label_encoding: Optional[dict] = None):
        """attribute name → (int label array, n_classes).

        Accepts the reference's iat_type aliases
        (gender/gender_science/test_weat → gender; race; age —
        datasets.py:30-42) and asserts label-set completeness exactly as the
        reference does (datasets.py:43).
        """
        if iat_type in ("gender", "gender_science", "test_weat"):
            column, default_enc = "gender", IATDataset.GENDER_ENCODING
        elif iat_type == "race":
            column, default_enc = "race", self.RACE_ENCODING
        elif iat_type == "age":
            column, default_enc = "age", IATDataset.AGE_ENCODING
        elif iat_type is None:
            raise ValueError(
                "iat_type must be one of gender/gender_science/test_weat/race/age "
                "(the reference's None default always raised; pass an attribute)"
            )
        else:
            raise NotImplementedError(f"iat_type={iat_type!r}")
        encoding = default_enc if label_encoding is None else label_encoding
        values = self.labels[column]
        assert set(values.unique()) == set(encoding.keys()), \
            "There is a missing label, invalid for WEAT"
        labels = np.array([encoding[v] for v in values], dtype=int)
        return labels, len(encoding)

    def __len__(self) -> int:
        return len(self.labels)


class FairFace(IATDataset):
    """FairFace (1.25-padding variant) with reference-parity construction.

    Construction order matches datasets.py:53-87: load {mode}_labels.csv,
    sort by file, optional _n_samples head, optional seeded gender balancing
    (sample min-count per gender with random_state=1), then label generation.
    """

    RACE_ENCODING = {
        "White": 0, "Southeast Asian": 1, "Middle Eastern": 2, "Black": 3,
        "Indian": 4, "Latino_Hispanic": 5, "East Asian": 6,
    }

    def __init__(
        self,
        iat_type: Optional[str] = None,
        lazy: bool = True,
        mode: str = "train",
        _n_samples: Union[float, int, None] = None,
        transforms: Optional[Callable] = None,
        equal_split: bool = True,
        data_path: Optional[os.PathLike] = None,
        download: bool = False,
    ):
        self.data_path = str(data_path or FAIRFACE_DATA_PATH)
        if download:
            _no_download("FairFace")
        self.mode = mode
        self._transforms = (lambda x: x) if transforms is None else transforms

        csv_path = os.path.join(self.data_path, "labels", mode, f"{mode}_labels.csv")
        self.labels = pd.read_csv(csv_path)
        self.labels.sort_values("file", inplace=True)

        self._subsample_and_balance(_n_samples, equal_split)

        self._img_fnames = [
            os.path.join(self.data_path, "imgs", "train_val", f)
            for f in self.labels["file"]
        ]

        self.iat_type = iat_type
        self.iat_labels, self.n_iat_classes = self.gen_labels(iat_type)

        self.images_list = None
        if not lazy:
            self.images_list = [self[i] for i in range(len(self))]

    def load_image(self, index: int):
        return _load_rgb(self._img_fnames[index])

    def __getitem__(self, index: int) -> Dotdict:
        if self.images_list is not None:
            return self.images_list[index]
        sample = Dotdict(dict(self.labels.iloc[index]))
        sample.img = self._transforms(self.load_image(index))
        sample.iat_label = int(self.iat_labels[index])
        return sample


class UTKFace(IATDataset):
    """UTKFace: labels are encoded in the filename
    ``[age]_[gender]_[race]_[datetime].jpg``.  Mapped onto the same label
    vocabulary as FairFace where possible (gender: UTK 0=male/1=female
    matches GENDER_ENCODING; age bucketed into the 9 FairFace ranges).
    Named in the build targets (BASELINE.json north star: FairFace/UTKFace).
    """

    RACE_ENCODING = {"White": 0, "Black": 1, "Asian": 2, "Indian": 3, "Others": 4}
    _RACE_NAMES = ["White", "Black", "Asian", "Indian", "Others"]
    _AGE_BUCKETS = [(0, 2), (3, 9), (10, 19), (20, 29), (30, 39),
                    (40, 49), (50, 59), (60, 69), (70, 10 ** 9)]
    _AGE_NAMES = list(IATDataset.AGE_ENCODING.keys())

    def __init__(
        self,
        iat_type: Optional[str] = None,
        mode: str = "train",
        _n_samples: Union[float, int, None] = None,
        transforms: Optional[Callable] = None,
        equal_split: bool = True,
        data_path: Optional[os.PathLike] = None,
        download: bool = False,
    ):
        self.data_path = str(data_path or UTKFACE_DATA_PATH)
        if download:
            _no_download("UTKFace")
        self.mode = mode
        self._transforms = (lambda x: x) if transforms is None else transforms

        rows = []
        img_dir = self.data_path
        for fname in sorted(os.listdir(img_dir)):
            if not fname.lower().endswith((".jpg", ".jpeg", ".png")):
                continue
            parts = fname.split("_")
            if len(parts) < 4:
                continue  # malformed names exist in the raw dump
            try:
                age, gender, race = int(parts[0]), int(parts[1]), int(parts[2])
            except ValueError:
                continue
            if (age < 0 or gender not in (0, 1)
                    or not 0 <= race < len(self._RACE_NAMES)):
                # out-of-range fields (the raw dump contains a few): skip
                # like other malformed names — indexing would crash on race
                # and a non-{0,1} gender would silently mislabel as Female
                continue
            bucket = next(
                name for (lo, hi), name in zip(self._AGE_BUCKETS, self._AGE_NAMES)
                if lo <= age <= hi
            )
            rows.append({
                "file": fname,
                "age": bucket,
                "gender": "Male" if gender == 0 else "Female",
                "race": self._RACE_NAMES[race],
            })
        if not rows:
            raise RuntimeError(
                f"no UTKFace images with parseable 'age_gender_race_*' "
                f"filenames under {img_dir}: point data_path / "
                "$DEBIAS_VLT_UTKFACE_PATH at a populated copy")
        self.labels = pd.DataFrame(rows)

        self._subsample_and_balance(_n_samples, equal_split)

        self._img_fnames = [
            os.path.join(self.data_path, f) for f in self.labels["file"]
        ]
        self.iat_type = iat_type
        self.iat_labels, self.n_iat_classes = self.gen_labels(iat_type)
        self.images_list = None

    def load_image(self, index: int):
        return _load_rgb(self._img_fnames[index])

    def __getitem__(self, index: int) -> Dotdict:
        sample = Dotdict(dict(self.labels.iloc[index]))
        sample.img = self._transforms(self.load_image(index))
        sample.iat_label = int(self.iat_labels[index])
        return sample
