"""Video ingest of the PyTorch port (data/video.py, the video branch of
data/loader.py) and ``measure_bias(dataset="video")`` against the JAX
package, on the CPU at the tiny Frozen-in-Time size of
tests/test_torch_frozen_in_time.py.

Videos are written here: frame directories with unpadded frame numbers
(``frame_2`` before ``frame_10`` only in natural order) and animated GIFs.
Bars: frames and batches equal to the JAX package's bit for bit; the
float32 metrics within 1e-5 of JAX's (the JAX package's pipeline of
tests/test_video.py); at int8 the image rows at cosine >= 0.9999 against
JAX's int8 kernels (interpret mode), and the metrics within 1e-5 of the
numpy oracle and JAX's ranking engine on the port's own rows (bf16
roundings flip near-tied ranks between two towers, so metrics of two towers
are not held equal there); a FiT on a
FairFace layout runs its images as 1-frame videos and matches JAX's
metrics; the embedding cache refuses a joint tower's file for the divided
tower built from the same tensors.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from debias_vision_lang_tpu.data.loader import HostLoader as JHostLoader
from debias_vision_lang_tpu.data.video import VideoDataset as JVideoDataset
from debias_vision_lang_tpu.data.video import load_frames as jload_frames
from debias_vision_lang_tpu.models.frozen_in_time import FrozenInTime as JFrozenInTime
from debias_vision_lang_torch.data.loader import HostLoader
from debias_vision_lang_torch.data.video import VideoDataset, load_frames
from debias_vision_lang_torch.eval import measure as tmeasure
from debias_vision_lang_torch.vision.preprocess import Preprocess as TPreprocess
from test_torch_frozen_in_time import CFG, fit_params_np, port_model

torch.set_num_threads(1)

RACES = ["White", "Southeast Asian", "Middle Eastern", "Black", "Indian",
         "Latino_Hispanic", "East Asian"]
AGES = ["0-2", "3-9", "10-19", "20-29", "30-39", "40-49", "50-59", "60-69", "more than 70"]
OPTS = {"batch_size": 4, "num_workers": 2, "topn": 4, "dataset": "video", "num_frames": 4}


@pytest.fixture(scope="module")
def video_root(tmp_path_factory):
    """8 frame directories of 12 PNG frames (frame_0 .. frame_11, unpadded)
    and 4 animated GIFs of 6 frames, 32 px, with a FairFace-vocabulary
    labels.csv."""
    root = tmp_path_factory.mktemp("videos_torch")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(8):
        vdir = root / f"vid{i}"
        vdir.mkdir()
        for f in range(12):
            Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(
                vdir / f"frame_{f}.png")
        rows.append({"file": f"vid{i}", "gender": "Male" if i % 2 else "Female",
                     "race": RACES[i % 7], "age": AGES[i % 9]})
    for i in range(8, 12):
        frames = [Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
                  for _ in range(6)]
        frames[0].save(root / f"vid{i}.gif", save_all=True, append_images=frames[1:])
        rows.append({"file": f"vid{i}.gif", "gender": "Male" if i % 2 else "Female",
                     "race": RACES[i % 7], "age": AGES[i % 9]})
    pd.DataFrame(rows).to_csv(root / "labels.csv", index=False)
    return str(root)


@pytest.fixture(scope="module")
def models():
    np_params = fit_params_np()
    jp = jax.tree.map(jnp.asarray, np_params)
    return {mode: (JFrozenInTime(params=jp, cfg=CFG, attention=mode),
                   port_model(np_params, attention=mode)) for mode in ("joint", "divided")}


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def tok(texts):
    """Deterministic toy tokenizer: SOT, two content ids, EOT (the max id)."""
    out = np.zeros((len(texts), 16), np.int64)
    for i, t in enumerate(texts):
        b = t.encode()
        out[i, :4] = [126, sum(b) % 100 + 1, len(b) % 23 + 1, 127]
    return out


class TestLoadFrames:
    def test_natural_order_and_subsample(self, video_root):
        path = os.path.join(video_root, "vid0")
        got = load_frames(path, 4)
        want = jload_frames(path, 4)
        np.testing.assert_array_equal(got, want)
        # frames 0, 3, 7, 11 of the natural order (frame_10 after frame_9)
        for j, f in enumerate((0, 3, 7, 11)):
            np.testing.assert_array_equal(
                got[j], np.asarray(Image.open(os.path.join(path, f"frame_{f}.png"))))

    def test_gif(self, video_root):
        path = os.path.join(video_root, "vid8.gif")
        got = load_frames(path, 4)
        assert got.shape == (4, 32, 32, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jload_frames(path, 4))

    @pytest.mark.parametrize("name", ["vid1", "vid9.gif"])
    def test_oversampling_repeats(self, video_root, name):
        path = os.path.join(video_root, name)
        got = load_frames(path, 20)
        assert got.shape == (20, 32, 32, 3)
        np.testing.assert_array_equal(got, jload_frames(path, 20))

    def test_empty_directory_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="no frames"):
            load_frames(str(tmp_path), 4)


class TestVideoDataset:
    @pytest.mark.parametrize("n", [None, 0.5, 6])
    def test_matches_jax(self, video_root, n):
        got = VideoDataset(video_root, iat_type="gender", num_frames=4, _n_samples=n)
        want = JVideoDataset(video_root, iat_type="gender", num_frames=4, _n_samples=n)
        assert list(got.labels["file"]) == list(want.labels["file"])
        np.testing.assert_array_equal(got.iat_labels, want.iat_labels)
        assert len(got) == (12 if n is None else 6) and got.n_iat_classes == 2
        np.testing.assert_array_equal(got.load_video(0), want.load_image(0))

    @pytest.mark.parametrize("n_px", [None, 32, 24])
    def test_host_loader_batches_5d(self, video_root, n_px):
        ds = VideoDataset(video_root, iat_type="race", num_frames=4)
        jds = JVideoDataset(video_root, iat_type="race", num_frames=4)
        got = list(HostLoader(ds, batch_size=5, num_workers=2, native_n_px=n_px))
        want = list(JHostLoader(jds, batch_size=5, num_workers=2, native_n_px=n_px))
        side = 32 if n_px is None else n_px
        assert [b.images.shape for b in got] == [(5, 4, side, side, 3)] * 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.images, w.images)
            np.testing.assert_array_equal(g.labels, w.labels)
            assert g.num_valid == w.num_valid
        assert got[-1].num_valid == 2

    def test_host_loader_refuses_patch_staging(self, video_root):
        ds = VideoDataset(video_root, iat_type="gender", num_frames=4)
        with pytest.raises(ValueError, match="does not support video"):
            next(iter(HostLoader(ds, batch_size=4, num_workers=1, native_n_px=32,
                                 native_patch=8)))


class TestMeasureVideo:
    @pytest.mark.parametrize("mode", ["joint", "divided"])
    def test_float32_metrics_match_jax(self, video_root, models, mode):
        from debias_vision_lang_tpu.eval.measure import measure_bias
        from debias_vision_lang_tpu.vision.preprocess import Preprocess

        jm, tm = models[mode]
        opts = {**OPTS, "data_path": video_root, "dtype": "float32"}
        want = measure_bias(jm, Preprocess(32), tok, "gender", opts=opts)
        got = tmeasure.measure_bias(tm, TPreprocess(32), tok, "gender", opts=opts)
        assert set(got) == set(want) == {"maxskew", "ndkl"}
        for ev in want:
            for k in want[ev]:
                assert got[ev][k] == pytest.approx(want[ev][k], abs=1e-5)

    @pytest.mark.parametrize("mode", ["joint", "divided"])
    def test_int8_embeddings_match_jax_kernels(self, video_root, models, mode, monkeypatch):
        """int8: the port runs its int8 fused blocks on bfloat16 activations
        (their twins here), as the JAX package does on its TPU; JAX's CPU
        default is its XLA int8 path (the exact GELU, other rounding
        points), so the JAX side runs its int8 Pallas kernels in interpret
        mode.  The two towers then differ by bf16 roundings (cosine >=
        0.9999), which flips near-tied ranks: the metrics are held to the
        oracle on the port's own embeddings (test_int8_metrics_rank_...)."""
        import functools

        from debias_vision_lang_tpu.eval.measure import get_labels_img_embeddings
        from debias_vision_lang_tpu.ops import fused_block_q as jfbq
        from debias_vision_lang_tpu.ops import quant as jquant

        monkeypatch.setattr(jquant, "_use_fused_q",
                            lambda s, w, dt, fused: dt == jnp.bfloat16)
        for name in ("fused_transformer_q", "fused_resblock_q"):
            monkeypatch.setattr(jfbq, name, functools.partial(getattr(jfbq, name),
                                                              interpret=True))
        jm, tm = models[mode]
        kw = {"batch_size": 4, "num_workers": 2, "native_n_px": 32}
        jl, je = get_labels_img_embeddings(
            JHostLoader(JVideoDataset(video_root, iat_type="gender"), **kw), jm, n_px=32,
            dtype="int8")
        tl, te = tmeasure.get_labels_img_embeddings(
            HostLoader(VideoDataset(video_root, iat_type="gender"), **kw), tm, n_px=32,
            dtype="int8")
        np.testing.assert_array_equal(tl, np.asarray(jl))
        cos = (_cos(te.numpy(), np.asarray(je, np.float32)))
        assert cos.min() >= 0.9999

    @pytest.mark.parametrize("mode", ["joint", "divided"])
    def test_int8_metrics_rank_the_towers_rows(self, tmp_path, video_root, models, mode):
        """The int8 measurement's metrics equal the numpy oracle's and the
        JAX package's ranking engine's on the embeddings the port's int8
        tower gave (kept by the embedding cache)."""
        from debias_vision_lang_tpu.eval.measure import eval_ranking as jrank

        _, tm = models[mode]
        cache = str(tmp_path / "int8.npz")
        got = tmeasure.measure_bias(tm, TPreprocess(32), tok, "gender",
                                    opts={**OPTS, "data_path": video_root, "dtype": "int8",
                                          "cache_embeddings": cache})
        qm, _ = tmeasure.resolve_compute(tm, "int8")
        prompts = tmeasure.get_prompt_embeddings(qm, tok, tmeasure.gen_prompts()).numpy()
        with np.load(cache) as data:
            labels, embs = data["labels"], data["embeddings"]
        for ev in got:
            oracle = tmeasure.eval_ranking(labels, embs, prompts, ev, 4, engine="oracle")
            jax_engine = jrank(labels, jnp.asarray(embs), jnp.asarray(prompts), ev, 4)
            for k in got[ev]:
                assert got[ev][k] == pytest.approx(oracle[k], abs=1e-5)
                assert got[ev][k] == pytest.approx(float(jax_engine[k]), abs=1e-5)

    @pytest.mark.parametrize("dtype", ["bfloat16", "int8-text"])
    def test_other_rungs_run(self, video_root, models, dtype):
        _, tm = models["divided"]
        got = tmeasure.measure_bias(tm, TPreprocess(32), tok, "race",
                                    opts={**OPTS, "data_path": video_root, "dtype": dtype})
        assert all(np.isfinite(v) for m in got.values() for v in m.values())

    def test_frames_are_preprocessed_one_by_one(self, video_root, models):
        """A 5-D batch reaches the tower normalised with the tower's own
        statistics, frame by frame: the embeddings are those of the frames
        preprocessed as images."""
        from debias_vision_lang_torch.vision.preprocess import preprocess_batch

        _, tm = models["joint"]
        ds = VideoDataset(video_root, iat_type="gender", num_frames=4)
        loader = HostLoader(ds, batch_size=4, num_workers=2, native_n_px=32)
        _, embs = tmeasure.get_labels_img_embeddings(loader, tm, n_px=32)
        u8 = torch.from_numpy(next(iter(loader)).images)
        vis = tm.cfg.vision
        x = preprocess_batch(u8.reshape(16, 32, 32, 3), 32, mean=vis.image_mean,
                             std=vis.image_std).reshape(4, 4, 32, 32, 3)
        with torch.no_grad():
            torch.testing.assert_close(embs[:4], tm.encode_image(x), rtol=0, atol=0)

    def test_fit_on_fairface_images_as_one_frame_videos(self, tmp_path, models):
        from debias_vision_lang_tpu.eval.measure import measure_bias
        from debias_vision_lang_tpu.vision.preprocess import Preprocess

        img_dir = tmp_path / "imgs" / "train_val" / "val"
        img_dir.mkdir(parents=True)
        rng = np.random.default_rng(42)
        rows = []
        for i in range(12):
            Image.fromarray(rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)).save(
                img_dir / f"{i}.jpg", quality=90)
            rows.append({"file": f"val/{i}.jpg", "age": "20-29",
                         "gender": "Male" if i % 2 == 0 else "Female",
                         "race": "White", "service_test": True})
        for mode in ("train", "val"):
            (tmp_path / "labels" / mode).mkdir(parents=True)
            pd.DataFrame(rows).to_csv(tmp_path / "labels" / mode / f"{mode}_labels.csv",
                                      index=False)
        jm, tm = models["divided"]
        opts = {"batch_size": 4, "num_workers": 2, "topn": 6, "data_path": str(tmp_path),
                "dtype": "float32"}
        want = measure_bias(jm, Preprocess(32), tok, "gender", opts=opts)
        got = tmeasure.measure_bias(tm, TPreprocess(32), tok, "gender", opts=opts)
        for ev in want:
            for k in want[ev]:
                assert got[ev][k] == pytest.approx(want[ev][k], abs=1e-5)


class TestCacheKey:
    def test_formulation_is_in_the_key(self, tmp_path, video_root, models):
        """The joint and divided towers share every tensor and give other
        embeddings: one's cache file refuses the other."""
        from debias_vision_lang_torch.models.frozen_in_time import formulation

        _, joint = models["joint"]
        _, divided = models["divided"]
        assert formulation(joint) == "joint" and formulation(divided) == "divided"
        cache = str(tmp_path / "video_cache.npz")
        opts = {**OPTS, "data_path": video_root, "cache_embeddings": cache}
        first = tmeasure.measure_bias(joint, TPreprocess(32), tok, "gender", opts=opts)
        assert os.path.exists(cache)
        assert tmeasure.measure_bias(joint, TPreprocess(32), tok, "gender", opts=opts) == first
        with np.load(cache) as data:
            assert '"video_attention": "joint"' in str(data["cache_key"])
        with pytest.raises(ValueError, match="the cached labels would be wrong"):
            tmeasure.measure_bias(divided, TPreprocess(32), tok, "gender", opts=opts)

    def test_image_towers_key_no_formulation(self):
        from debias_vision_lang_torch.models.frozen_in_time import formulation

        assert formulation(object()) is None
