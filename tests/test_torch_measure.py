"""The measure_bias slice of the PyTorch port against the JAX package, on the
CPU: prompts, ranking metrics (vs the numpy oracle, atol 1e-5), the host
loader (batches equal), and measure_bias end to end on a synthetic FairFace
(float32 metrics within 1e-5; bfloat16 image embeddings at cosine >= 0.999
against JAX's bfloat16 XLA path, the JAX package's own fused-vs-XLA bar).
The int8 rungs: image embeddings at cosine >= 0.999 against JAX's int8
path, and measure_bias(dtype="int8" / "int8-text") metrics equal to the
numpy oracle on the port's own embeddings within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from debias_vision_lang_tpu.core.config import (CLIPConfig, DebiasConfig,
                                                TextConfig, VisionConfig)
from debias_vision_lang_tpu.data.datasets import FairFace
from debias_vision_lang_tpu.metrics import oracle
from debias_vision_lang_torch.data.loader import HostLoader
from debias_vision_lang_torch.eval import measure as tmeasure
from debias_vision_lang_torch.metrics import ranking
from debias_vision_lang_torch.models import clip as tclip
from debias_vision_lang_torch.models.convert import params_from_jax, to_jax_tree
from debias_vision_lang_torch.models.debias import DebiasCLIP as TDebiasCLIP
from debias_vision_lang_torch.ops import quant as tquant
from debias_vision_lang_torch.vision.preprocess import Preprocess as TPreprocess
from torch_port_config import port_config

torch.set_num_threads(1)

CFG = CLIPConfig(
    name="tiny",
    vision=VisionConfig(kind="vit", image_size=32, patch_size=8, width=64,
                        layers=2, heads=2, embed_dim=32),
    text=TextConfig(vocab_size=512, context_length=77, width=32, layers=2,
                    heads=2, embed_dim=32))
TCFG = port_config(CFG)  # the port's own config object, same fields


@pytest.fixture(scope="module")
def fairface(tmp_path_factory):
    """Miniature FairFace layout (as tests/test_data_eval.py builds it)."""
    root = tmp_path_factory.mktemp("fairface_torch")
    img_dir = root / "imgs" / "train_val" / "val"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(42)
    rows = []
    for i in range(24):
        Image.fromarray(rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)).save(
            img_dir / f"{i}.jpg", quality=90)
        rows.append({"file": f"val/{i}.jpg", "age": "20-29",
                     "gender": "Male" if i % 2 == 0 else "Female",
                     "race": "White", "service_test": True})
    for mode in ("train", "val"):
        (root / "labels" / mode).mkdir(parents=True)
        pd.DataFrame(rows).to_csv(root / "labels" / mode / f"{mode}_labels.csv",
                                  index=False)
    return str(root)


@pytest.fixture(scope="module")
def models():
    """(JAX DebiasCLIP, port DebiasCLIP) holding the same weights."""
    from debias_vision_lang_tpu.models.debias import DebiasCLIP as JDebiasCLIP

    rng = np.random.default_rng(0)
    np_params = jax.tree.map(
        lambda a: (a + 0.02 * rng.normal(size=a.shape)).astype(np.float32),
        to_jax_tree(tclip.init_clip_params(TCFG, torch.Generator().manual_seed(1))))
    deb = rng.normal(size=(2, 32)).astype(np.float32)
    dcfg = DebiasConfig(num_debias_tokens=2, hidden_dim=32)
    jmodel = JDebiasCLIP(clip_params=jax.tree.map(jnp.asarray, np_params),
                         debias_tokens=jnp.asarray(deb), clip_cfg=CFG, debias_cfg=dcfg)
    clip = tclip.CLIP(TCFG)
    clip.load_state_dict(params_from_jax(np_params, TCFG))
    return jmodel, TDebiasCLIP(clip, torch.from_numpy(deb), port_config(dcfg))


def tok(texts):
    """Deterministic toy tokenizer: SOT, two content ids, EOT (max id)."""
    out = np.zeros((len(texts), 77), np.int64)
    for i, t in enumerate(texts):
        b = t.encode()
        out[i, :4] = [510, sum(b) % 400 + 1, len(b) % 97 + 1, 511]
    return out


def _cos_rows(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def test_gen_prompts_same_319():
    from debias_vision_lang_tpu.eval.measure import gen_prompts

    got = tmeasure.gen_prompts()
    assert len(got) == 319
    assert got == gen_prompts()


class TestRanking:
    @staticmethod
    def _data(kind):
        rng = np.random.default_rng(3)
        labels = rng.integers(0, 3, 40)
        labels[:3] = [0, 1, 2]
        img = rng.normal(size=(40, 8)).astype(np.float32)
        prm = rng.normal(size=(6, 8)).astype(np.float32)
        if kind == "tied":  # few distinct scores: boundary ties everywhere
            img = np.round(img).clip(-1, 1).astype(np.float32)
            prm = np.round(prm).clip(-1, 1).astype(np.float32)
        return labels, img, prm

    @pytest.mark.parametrize("kind", ["random", "tied"])
    @pytest.mark.parametrize("evaluation", ["maxskew", "ndkl"])
    @pytest.mark.parametrize("topn", [1.0, 7, 0.3, 50])
    def test_matches_oracle(self, kind, evaluation, topn):
        labels, img, prm = self._data(kind)
        want = oracle.eval_ranking_oracle(labels, img, prm, evaluation, topn)
        got = ranking.eval_ranking(labels, torch.from_numpy(img), torch.from_numpy(prm),
                                   evaluation, topn)
        assert set(got) == set(want) == {"eq_opp", "dem_par"}
        for k in want:
            assert got[k] == pytest.approx(want[k], abs=1e-5)

    def test_oracle_engine_and_negative_zero(self):
        labels, img, prm = self._data("tied")
        img[5] = -0.0  # -0.0 and +0.0 scores must tie
        a = tmeasure.eval_ranking(labels, torch.from_numpy(img), torch.from_numpy(prm),
                                  "ndkl", 9, engine="oracle")
        b = tmeasure.eval_ranking(labels, torch.from_numpy(img), torch.from_numpy(prm),
                                  "ndkl", 9)
        for k in a:
            assert a[k] == pytest.approx(b[k], abs=1e-5)

    def test_rejects_sparse_labels(self):
        with pytest.raises(ValueError, match="dense"):
            ranking.eval_ranking(np.array([0, 2]), torch.ones(2, 4), torch.ones(1, 4))


class TestHostLoader:
    @pytest.mark.parametrize("native_on", [True, False])
    @pytest.mark.parametrize("staging", [None, "n_px", "p8"])
    @pytest.mark.parametrize("order", [{}, {"shuffle": True, "seed": 3,
                                            "drop_remainder": True}])
    def test_batches_equal_jax_loader(self, fairface, monkeypatch, native_on, staging,
                                      order):
        from debias_vision_lang_torch import native as tnative
        from debias_vision_lang_tpu import native
        from debias_vision_lang_tpu.data.loader import HostLoader as JHostLoader

        if not native_on:  # both loaders' own native ingest off
            monkeypatch.setattr(native, "available", lambda: False)
            monkeypatch.setattr(tnative, "available", lambda: False)
        ds = FairFace(mode="val", iat_type="gender", data_path=fairface, download=False)
        kw = {"batch_size": 10, "num_workers": 2, **order}
        if staging:
            kw["native_n_px"] = 32
        if staging == "p8":
            kw["native_patch"] = 8
        got, want = list(HostLoader(ds, **kw)), list(JHostLoader(ds, **kw))
        expected = [10, 10] if order else [10, 10, 4]
        assert [b.num_valid for b in got] == [b.num_valid for b in want] == expected
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.images, w.images)
            np.testing.assert_array_equal(g.labels, w.labels)


OPTS = {"batch_size": 8, "num_workers": 2, "topn": 10}


class TestMeasureBias:
    def test_float32_metrics_match_jax(self, fairface, models):
        from debias_vision_lang_tpu.eval.measure import measure_bias
        from debias_vision_lang_tpu.vision.preprocess import Preprocess

        jmodel, tmodel = models
        opts = {**OPTS, "data_path": fairface, "dtype": "float32"}
        want = measure_bias(jmodel, Preprocess(32), tok, "gender", opts=opts)
        got = tmeasure.measure_bias(tmodel, TPreprocess(32), tok, "gender", opts=opts)
        assert set(got) == set(want) == {"maxskew", "ndkl"}
        for ev in want:
            for k in want[ev]:
                assert got[ev][k] == pytest.approx(want[ev][k], abs=1e-5)

    def test_bfloat16_embeddings_match_jax_xla(self, fairface, models):
        from debias_vision_lang_tpu.data.loader import HostLoader as JHostLoader
        from debias_vision_lang_tpu.eval.measure import get_labels_img_embeddings

        jmodel, tmodel = models
        ds = FairFace(mode="val", iat_type="gender", data_path=fairface, download=False)
        kw = {"batch_size": 8, "num_workers": 2, "native_n_px": 32, "native_patch": 8}
        jl, je = get_labels_img_embeddings(JHostLoader(ds, **kw), jmodel, n_px=32,
                                           dtype="bfloat16")
        tl, te = tmeasure.get_labels_img_embeddings(HostLoader(ds, **kw), tmodel,
                                                    n_px=32, dtype="bfloat16")
        np.testing.assert_array_equal(tl, jl)
        assert te.shape == (24, 32) and te.dtype == torch.float32
        assert _cos_rows(te.numpy(), np.asarray(je)).min() >= 0.999

    def test_bfloat16_runs_p8_through_fused_blocks(self, fairface, models, monkeypatch):
        from debias_vision_lang_torch.ops import fused_block as fb

        _, tmodel = models
        calls = []
        orig = fb.mlp_block
        monkeypatch.setattr(fb, "mlp_block", lambda *a, **k: calls.append(1) or orig(*a, **k))
        staged = []
        orig_p8 = tclip.encode_image_vit_p8
        monkeypatch.setattr(tclip, "encode_image_vit_p8",
                            lambda *a, **k: staged.append(1) or orig_p8(*a, **k))
        got = tmeasure.measure_bias(tmodel, TPreprocess(32), tok, "gender",
                                    opts={**OPTS, "data_path": fairface,
                                          "dtype": "bfloat16"})
        assert len(staged) == 3  # 24 images / batch 8, all patch-staged
        assert len(calls) == 3 * CFG.vision.layers  # text stays float32
        assert all(np.isfinite(v) for m in got.values() for v in m.values())

    def test_custom_prompts(self, fairface, models):
        _, tmodel = models
        got = tmeasure.measure_bias(
            tmodel, TPreprocess(32), tok, "gender",
            opts={**OPTS, "data_path": fairface, "evaluations": ("ndkl",),
                  "prompts": np.array(["a good person", "a bad person"])})
        assert set(got) == {"ndkl"}


class TestInt8Rungs:
    def test_int8_embeddings_match_jax(self, fairface, models):
        from debias_vision_lang_tpu.data.loader import HostLoader as JHostLoader
        from debias_vision_lang_tpu.eval.measure import get_labels_img_embeddings

        jmodel, tmodel = models
        ds = FairFace(mode="val", iat_type="gender", data_path=fairface, download=False)
        kw = {"batch_size": 8, "num_workers": 2, "native_n_px": 32, "native_patch": 8}
        jl, je = get_labels_img_embeddings(JHostLoader(ds, **kw), jmodel, n_px=32,
                                           dtype="int8")
        tl, te = tmeasure.get_labels_img_embeddings(HostLoader(ds, **kw), tmodel,
                                                    n_px=32, dtype="int8")
        np.testing.assert_array_equal(tl, jl)
        assert te.shape == (24, 32) and te.dtype == torch.float32
        assert _cos_rows(te.numpy(), np.asarray(je)).min() >= 0.999

    @pytest.mark.parametrize("dtype", ["int8", "int8-text"])
    def test_metrics_equal_oracle(self, fairface, models, dtype):
        _, tmodel = models
        opts = {**OPTS, "data_path": fairface, "dtype": dtype}
        got = tmeasure.measure_bias(tmodel, TPreprocess(32), tok, "gender", opts=opts)
        # the same pipeline by hand, ranked by the numpy oracle
        qmodel, _ = tquant.resolve_compute(tmodel, dtype)
        ds = FairFace(mode="val", iat_type="gender", data_path=fairface, download=False)
        labels, img = tmeasure.get_labels_img_embeddings(
            HostLoader(ds, batch_size=8, num_workers=2, native_n_px=32, native_patch=8),
            qmodel, n_px=32, dtype=dtype)
        prm = tmeasure.get_prompt_embeddings(qmodel, tok, tmeasure.gen_prompts())
        for ev in ("maxskew", "ndkl"):
            want = oracle.eval_ranking_oracle(labels, img.numpy(), prm.numpy(), ev, 10)
            for k in want:
                assert np.isfinite(got[ev][k])
                assert got[ev][k] == pytest.approx(want[k], abs=1e-5)

    @pytest.mark.parametrize("dtype,text_layers", [("int8", 0), ("int8-text", 2)])
    def test_runs_p8_through_int8_blocks(self, fairface, models, monkeypatch, dtype,
                                         text_layers):
        from debias_vision_lang_torch.ops import fused_block_q as fbq

        _, tmodel = models
        calls = []
        orig = fbq.attention_block_q
        monkeypatch.setattr(fbq, "attention_block_q",
                            lambda *a, **k: calls.append(k["causal"]) or orig(*a, **k))
        staged = []
        orig_p8 = tquant.patch_embed_q_p8
        monkeypatch.setattr(tquant, "patch_embed_q_p8",
                            lambda *a, **k: staged.append(1) or orig_p8(*a, **k))
        tmeasure.measure_bias(tmodel, TPreprocess(32), tok, "gender",
                              opts={**OPTS, "data_path": fairface, "dtype": dtype})
        assert len(staged) == 3  # 24 images / batch 8, all patch-staged
        assert calls.count(False) == 3 * CFG.vision.layers
        assert calls.count(True) == text_layers  # 319 prompts in one text batch


class TestMeshOpts:
    """``mesh`` and ``sharded_metrics`` run the distribution path
    (tests/test_torch_parallel.py holds it at length): on the CPU "auto" is
    one slot, and ``sharded_metrics`` without a mesh is the single-device
    engine, as in JAX."""

    @pytest.mark.parametrize("extra", [{"mesh": "auto"}, {"sharded_metrics": True},
                                       {"mesh": "auto", "sharded_metrics": True}])
    def test_mesh_opts_equal_the_unsharded_call(self, models, fairface, extra):
        _, tmodel = models
        opts = {**OPTS, "data_path": fairface}
        want = tmeasure.measure_bias(tmodel, TPreprocess(32), tok, "gender", opts=opts)
        got = tmeasure.measure_bias(tmodel, TPreprocess(32), tok, "gender",
                                    opts={**opts, **extra})
        for ev in want:
            assert got[ev] == pytest.approx(want[ev], abs=1e-6), ev


class TestOptsChecked:
    @pytest.mark.parametrize("opts,exc,match", [
        ({"topnn": 5}, ValueError, "topnn"),
        ({"prompts": np.array([], dtype=str)}, ValueError, "empty"),
        ({"prompts": []}, ValueError, "empty"),
        ({"dtype": "int8"}, NotImplementedError, "OpenAI ViT towers"),
        ({"dtype": "int8-text"}, NotImplementedError, "OpenAI ViT towers"),
        ({"dtype": "float16"}, ValueError, "unknown dtype"),
        ({"dataset": "webvid"}, NotImplementedError, "webvid"),
    ])
    def test_rejected_before_any_work(self, opts, exc, match):
        with pytest.raises(exc, match=match):
            tmeasure.measure_bias(None, None, None, opts=opts)

    def test_auto_is_the_int8_rung(self, models, fairface, monkeypatch):
        """"auto" on a ViT runs the int8 rung (JAX's resolve_rung): the int8
        call's metrics bit for bit, through the patch-staged int8 stem."""
        _, tmodel = models
        staged = []
        orig = tmeasure.HostLoader.__init__

        def spy(self, *a, **k):
            staged.append(k.get("native_patch"))
            orig(self, *a, **k)

        monkeypatch.setattr(tmeasure.HostLoader, "__init__", spy)
        opts = {**OPTS, "data_path": fairface}
        got = tmeasure.measure_bias(tmodel, TPreprocess(32), tok, "gender",
                                    opts={**opts, "dtype": "auto"})
        want = tmeasure.measure_bias(tmodel, TPreprocess(32), tok, "gender",
                                     opts={**opts, "dtype": "int8"})
        assert got == want and staged == [8, 8]
