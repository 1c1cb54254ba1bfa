"""``run_training`` of the PyTorch port (debias_vision_lang_torch/train/loop.py)
on a synthetic FairFace layout and a tiny model, on the CPU: the loop, the
frozen-embedding cache against the decode path, the disk cache (relative-
path dataset fingerprint, (size, mtime) file keys), resume, the `.pt`
export, and the batch streams against the JAX loop's."""

import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from debias_vision_lang_torch.core.config import (CLIPConfig, DebiasConfig, TextConfig,
                                                  TrainConfig, VisionConfig)
from debias_vision_lang_torch.models.clip import CLIP, init_clip_params
from debias_vision_lang_torch.models.debias import DebiasCLIP

torch.set_num_threads(1)

CTX, VOCAB, PX = 16, 128, 32
PROMPTS = ["a good person", "a bad person"]


def _write_fairface(root, n=16, seed=0):
    img_dir = root / "imgs" / "train_val" / "x"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    races = ["White", "Southeast Asian", "Middle Eastern", "Black", "Indian",
             "Latino_Hispanic", "East Asian"]
    ages = ["0-2", "3-9", "10-19", "20-29", "30-39", "40-49", "50-59", "60-69",
            "more than 70"]
    rows = []
    for i in range(n):
        f = f"x/{i}.jpg"
        Image.fromarray(rng.integers(0, 256, (PX, PX, 3), dtype=np.uint8)).save(
            root / "imgs" / "train_val" / f)
        rows.append({"file": f, "age": ages[i % 9], "gender": "Male" if i % 2 else "Female",
                     "race": races[i % 7]})
    for mode in ("train", "val"):
        d = root / "labels" / mode
        d.mkdir(parents=True)
        pd.DataFrame(rows).to_csv(d / f"{mode}_labels.csv", index=False)
    return str(root)


@pytest.fixture(scope="module")
def ff_root(tmp_path_factory):
    return _write_fairface(tmp_path_factory.mktemp("ff_train"))


@pytest.fixture(scope="module")
def pairs_root(ff_root, tmp_path_factory):
    root = tmp_path_factory.mktemp("pairs")
    os.symlink(os.path.join(ff_root, "imgs", "train_val"), root / "images")
    pd.DataFrame({"file": [f"x/{i}.jpg" for i in range(16)],
                  "caption": [f"a photo number {i}" for i in range(16)]}
                 ).to_csv(root / "captions.csv", index=False)
    return str(root)


def tiny_model(name="tiny-loop", **dkw):
    cfg = CLIPConfig(
        name=name,
        vision=VisionConfig(kind="vit", image_size=PX, patch_size=8, width=32, layers=1,
                            heads=2, embed_dim=16),
        text=TextConfig(vocab_size=VOCAB, context_length=CTX, width=32, layers=1, heads=2,
                        embed_dim=16))
    clip = CLIP(cfg)
    clip.load_state_dict(init_clip_params(cfg, torch.Generator().manual_seed(0)))
    tokens = torch.randn(2, 32, generator=torch.Generator().manual_seed(1)) * 0.02
    return DebiasCLIP(clip, tokens, DebiasConfig(num_debias_tokens=2, hidden_dim=32,
                                                 max_tokens=CTX, **dkw))


def tok(texts):
    out = np.zeros((len(texts), CTX), np.int64)
    out[:, 0] = VOCAB - 2
    for i, t in enumerate(texts):
        out[i, 1] = sum(t.encode()) % 100 + 1
        out[i, 2] = VOCAB - 1
    return out


def _run(ff_root, ckpt_dir, cached=True, pairs_path=None, epochs=2, resume=False,
         cache_dir=None, model=None, **kw):
    from debias_vision_lang_torch.train.loop import run_training

    return run_training(
        model=model if model is not None else tiny_model(), tokenizer=tok,
        attribute="gender", data_path=ff_root, pairs_path=pairs_path,
        checkpoint_dir=ckpt_dir, eval_n_samples=None, sensitive_prompts=PROMPTS,
        progress=False, resume=resume, device="cpu",
        train_cfg=TrainConfig(batch_size=8, num_epochs=epochs, eval_every_steps=1,
                              cache_frozen_embeddings=cached,
                              embedding_cache_dir=cache_dir), **kw)


def _export(res):
    return torch.load(res["export"], map_location="cpu", weights_only=True).numpy()


def _losses(res):
    log = os.path.join(res["checkpoint_dir"], "logs", "metrics.jsonl")
    return [rec["loss"] for rec in map(json.loads, open(log)) if "loss" in rec]


class TestRunTraining:
    def test_full_loop(self, ff_root, tmp_path):
        res = _run(ff_root, str(tmp_path / "ckpt"), epochs=1)
        assert res["steps"] == 2  # 16 images / batch 8
        assert np.isfinite(res["best_ndkl"]) and np.isfinite(res["final_ndkl"])
        t = torch.load(res["export"], map_location="cpu", weights_only=True)
        assert type(t) is torch.Tensor and tuple(t.shape) == (2, 32)
        assert t.dtype == torch.float32
        assert {"step_1.pt", "step_2.pt"} <= set(os.listdir(res["checkpoint_dir"]))
        lines = [json.loads(x) for x in open(os.path.join(res["checkpoint_dir"], "logs",
                                                          "metrics.jsonl"))]
        assert any("ndkl_eq_opp" in x for x in lines)
        assert any("adversary_bce" in x for x in lines)

    def test_schedule_horizon_derived_and_slash_alias(self, ff_root, tmp_path):
        from debias_vision_lang_torch.train.loop import run_training

        res = run_training(model=tiny_model(name="ViT-B/16"), tokenizer=tok,
                           attribute="gender", epochs=1, batch_size=8, data_path=ff_root,
                           checkpoint_dir=str(tmp_path / "c"), eval_every=0,
                           eval_n_samples=None, sensitive_prompts=PROMPTS, progress=False,
                           lr_schedule="warmup_cosine", warmup_steps=1, grad_clip_norm=1.0,
                           device="cpu")
        assert res["steps"] == 2 and np.isfinite(res["best_ndkl"])
        assert "/16" not in os.path.basename(res["export"])

    def test_mesh_raises(self, ff_root, tmp_path):
        with pytest.raises(NotImplementedError, match="queue 1 item 5"):
            _run(ff_root, str(tmp_path / "m"), mesh="auto")

    def test_image_training_bypasses_the_cache(self, ff_root, tmp_path):
        res = _run(ff_root, str(tmp_path / "layers"), epochs=1,
                   model=tiny_model(freeze_proj=False))
        assert res["embed_cache"] is False and np.isfinite(res["best_ndkl"])

    def test_resume(self, ff_root, tmp_path):
        ckpt = str(tmp_path / "resume")
        first = _run(ff_root, ckpt, epochs=1)
        assert first["embed_cache"] is True and first["steps"] == 2
        again = _run(ff_root, ckpt, epochs=1, resume=True)
        assert again["steps"] == 2  # the recipe is not extended
        assert again["embed_cache"] is False  # and nothing is precomputed
        longer = _run(ff_root, ckpt, epochs=2, resume=True)
        assert longer["steps"] == 4


class TestEmbedCache:
    @pytest.mark.parametrize("use_pairs", [False, True], ids=["fairface-fallback", "pairs"])
    def test_cached_equals_decode_path(self, ff_root, pairs_root, tmp_path, use_pairs):
        runs = {}
        for cached in (True, False):
            res = _run(ff_root, str(tmp_path / f"c{cached}"), cached,
                       pairs_path=pairs_root if use_pairs else None)
            assert res["embed_cache"] is cached and res["steps"] == 4
            runs[cached] = res
        a, b = runs[True], runs[False]
        assert _losses(a) == _losses(b)
        assert a["best_ndkl"] == b["best_ndkl"]
        np.testing.assert_array_equal(_export(a), _export(b))

    def test_disk_cache_hits_and_misses(self, ff_root, pairs_root, tmp_path):
        cache = str(tmp_path / "emb")
        r1 = _run(ff_root, str(tmp_path / "d1"), pairs_path=pairs_root, cache_dir=cache)
        assert r1["embed_cache_disk"] == {"train": "miss", "captions": "miss"}
        assert len(os.listdir(cache)) == 2
        r2 = _run(ff_root, str(tmp_path / "d2"), pairs_path=pairs_root, cache_dir=cache)
        assert r2["embed_cache_disk"] == {"train": "hit", "captions": "hit"}
        np.testing.assert_array_equal(_export(r1), _export(r2))
        # another tower misses
        other = tiny_model()
        with torch.no_grad():
            other.clip.logit_scale.add_(0.25)
        r3 = _run(ff_root, str(tmp_path / "d3"), pairs_path=pairs_root, cache_dir=cache,
                  model=other)
        assert r3["embed_cache_disk"] == {"train": "miss", "captions": "miss"}
        # a corrupt file is a miss, recomputed and rewritten
        train_file = [f for f in sorted(os.listdir(cache)) if f.startswith("train_rows_")]
        for f in train_file:
            with open(os.path.join(cache, f), "wb") as fh:
                fh.write(b"not an npz")
        r4 = _run(ff_root, str(tmp_path / "d4"), pairs_path=pairs_root, cache_dir=cache)
        assert r4["embed_cache_disk"] == {"train": "miss", "captions": "hit"}

    def test_fallback_branch_shares_train_rows(self, ff_root, tmp_path):
        cache = str(tmp_path / "fb")
        r1 = _run(ff_root, str(tmp_path / "f1"), cache_dir=cache, epochs=1)
        assert r1["embed_cache_disk"] == {"train": "miss", "captions": "train-rows"}
        assert len(os.listdir(cache)) == 1
        r2 = _run(ff_root, str(tmp_path / "f2"), cache_dir=cache, epochs=1)
        assert r2["embed_cache_disk"] == {"train": "hit", "captions": "train-rows"}

    def test_moved_root_hits_rewritten_file_misses(self, tmp_path):
        """The dataset fingerprint hashes paths relative to the root, so a
        moved dataset keeps its rows; a file rewritten under the same name
        has a new (size, mtime) and misses."""
        import time

        root = _write_fairface(tmp_path / "ff_a", seed=3)
        cache = str(tmp_path / "mv")
        r1 = _run(root, str(tmp_path / "m1"), cache_dir=cache, epochs=1)
        assert r1["embed_cache_disk"]["train"] == "miss"
        moved = str(tmp_path / "ff_b")
        shutil.move(root, moved)
        r2 = _run(moved, str(tmp_path / "m2"), cache_dir=cache, epochs=1)
        assert r2["embed_cache_disk"]["train"] == "hit"
        np.testing.assert_array_equal(_export(r1), _export(r2))
        time.sleep(0.01)
        img = os.path.join(moved, "imgs", "train_val", "x", "3.jpg")
        Image.fromarray(np.zeros((PX, PX, 3), np.uint8)).save(img)
        r3 = _run(moved, str(tmp_path / "m3"), cache_dir=cache, epochs=1)
        assert r3["embed_cache_disk"]["train"] == "miss"

    def test_fingerprints(self, ff_root, tmp_path):
        from debias_vision_lang_torch.data.datasets import FairFace
        from debias_vision_lang_torch.train import embcache as ec

        ds = FairFace(mode="train", iat_type="gender", data_path=ff_root, download=False)
        copy = shutil.copytree(ff_root, str(tmp_path / "copy"))
        ds2 = FairFace(mode="train", iat_type="gender", data_path=copy, download=False)
        assert ec.dataset_fingerprint(ds) == ec.dataset_fingerprint(ds2)
        assert ec.files_fingerprint(ds._img_fnames) == ec.files_fingerprint(ds2._img_fnames)
        sd = tiny_model().clip.state_dict()
        assert ec.params_fingerprint(sd) == ec.params_fingerprint(tiny_model().clip.state_dict())
        sd["logit_scale"] = sd["logit_scale"] + 1
        assert ec.params_fingerprint(sd) != ec.params_fingerprint(tiny_model().clip.state_dict())


class TestBatchStreams:
    """The port trains on the JAX loop's batches: the same numpy streams."""

    def test_loader_order_equals_jax(self, ff_root):
        from debias_vision_lang_torch.data.datasets import FairFace
        from debias_vision_lang_torch.data.loader import HostLoader
        from debias_vision_lang_tpu.data.datasets import FairFace as JaxFairFace
        from debias_vision_lang_tpu.data.loader import HostLoader as JaxLoader

        kw = {"mode": "train", "iat_type": "gender", "data_path": ff_root, "download": False}
        a = JaxLoader(JaxFairFace(**kw), batch_size=8, drop_remainder=True, shuffle=True, seed=5)
        b = HostLoader(FairFace(**kw), batch_size=8, drop_remainder=True, shuffle=True, seed=5)
        for _ in range(2):  # two epochs
            for x, y in zip(a.iter_index_batches(), b.iter_index_batches(), strict=True):
                np.testing.assert_array_equal(x.images, y.images)
                np.testing.assert_array_equal(x.labels, y.labels)

    def test_caption_stream_equals_jax(self):
        from debias_vision_lang_tpu.train.loop import _caption_index_stream as jax_stream
        from debias_vision_lang_torch.train.loop import _caption_index_stream

        a = jax_stream(4, np.random.default_rng([0, 1]), n=10)
        b = _caption_index_stream(4, np.random.default_rng([0, 1]), n=10)
        for _ in range(7):
            np.testing.assert_array_equal(next(a), next(b))

    def test_caption_batches_not_lockstep(self, ff_root):
        from debias_vision_lang_torch.data.datasets import FairFace
        from debias_vision_lang_torch.data.loader import HostLoader
        from debias_vision_lang_torch.train.loop import _caption_batches

        ds = FairFace(mode="train", iat_type="gender", data_path=ff_root, download=False)
        loader = HostLoader(ds, batch_size=8, drop_remainder=True, shuffle=True, seed=0)
        cap_images, cap_tokens = next(_caption_batches(None, tok, 8, ds, PX,
                                                       np.random.default_rng([0, 1])))
        assert cap_tokens.shape == (8, CTX)
        assert not np.array_equal(next(iter(loader)).images, cap_images)
