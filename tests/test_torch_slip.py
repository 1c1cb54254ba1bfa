"""The SLIP tower family (``slip_vit``: a timm ViT with a conv bias, no
pre-LN and the exact erf GELU) in the PyTorch port against the JAX package,
on the CPU at a tiny size (width 128, 2 layers, 2 heads of 64, patch 8,
32 px).  The same JAX-initialised weights (every leaf perturbed, so the
conv bias and every LayerNorm are non-trivial) go through both packages.

Bars: the parameter tree and the weight bridge exact; float32 towers
(conv stem and P8 staging with the folded bias) within 1e-5; the exact
GELU within 1e-6 of ``jax.nn.gelu(approximate=False)``; the bf16 fused
tower (the port's twins) against the JAX Pallas kernels in interpret mode
at the JAX package's own bf16 bars (atol 2e-2 + rtol 1e-2, cosine >
0.9999); the int8 rung's weight codes bit-exact against JAX
``QuantizedCLIP``'s, its plain float32 tower within 5e-3 of JAX's XLA int8
path and its bf16 fused tower at cosine >= 0.999; ``measure_bias`` float32
metrics within 1e-5 of JAX's.
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
from debias_vision_lang_tpu.models import clip as jclip
from debias_vision_lang_tpu.ops import quant as jquant
from debias_vision_lang_torch.models import clip as tclip
from debias_vision_lang_torch.models import layers as tlayers
from debias_vision_lang_torch.models.convert import params_from_jax, to_jax_tree
from debias_vision_lang_torch.models.debias import DebiasCLIP as TDebiasCLIP
from debias_vision_lang_torch.ops import fused_block as fb
from debias_vision_lang_torch.ops import fused_block_q as fbq
from debias_vision_lang_torch.ops import quant as tquant
from debias_vision_lang_torch.vision.preprocess import patchify_u8
from torch_port_config import port_config

torch.set_num_threads(1)

CFG = CLIPConfig(
    name="slip-tiny",
    vision=VisionConfig(kind="slip_vit", image_size=32, patch_size=8, width=128,
                        layers=2, heads=2, embed_dim=32,
                        image_mean=(0.485, 0.456, 0.406), image_std=(0.229, 0.224, 0.225)),
    text=TextConfig(vocab_size=512, context_length=77, width=64, layers=2, heads=1,
                    embed_dim=32))
TCFG = port_config(CFG)
F32_ATOL = 1e-5
XLA_INT8_ATOL = 5e-3


@pytest.fixture(scope="module")
def pair():
    """(JAX params, numpy params, port CLIP) holding the same weights."""
    rng = np.random.default_rng(0)
    np_params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        jclip.init_clip_params(jax.random.key(0), CFG))
    model = tclip.CLIP(TCFG)
    model.load_state_dict(params_from_jax(np_params, TCFG))
    return jax.tree.map(jnp.asarray, np_params), np_params, model


def _np(t):
    return np.asarray(t.detach().float() if torch.is_tensor(t) else t, np.float32)


def _cos_rows(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _u8(seed, b=3):
    return np.random.default_rng(seed).integers(0, 256, (b, 32, 32, 3), dtype=np.uint8)


class TestTree:
    def test_init_matches_jax_structure(self):
        """No ln_pre, a conv bias: the port's init is JAX's tree, leaf by leaf."""
        sd = tclip.init_clip_params(TCFG)
        want = jax.eval_shape(lambda: jclip.init_clip_params(jax.random.key(0), CFG))
        got = to_jax_tree(sd)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        jax.tree.map(lambda w, g: w.shape == g.shape or pytest.fail(str(w.shape)), want, got)
        assert "visual.conv1.bias" in sd and not any("ln_pre" in k for k in sd)
        assert float(sd["visual.conv1.bias"].abs().max()) == 0.0  # JAX: zeros

    def test_params_from_jax_exact(self, pair):
        _, np_params, model = pair
        np.testing.assert_array_equal(_np(model.visual.conv1.bias),
                                      np_params["visual"]["conv1"]["bias"])
        np.testing.assert_array_equal(_np(model.visual.resblocks[1].mlp.w1),
                                      np_params["visual"]["resblocks"]["mlp"]["w1"][1])
        assert model.visual.ln_pre is None

    def test_openai_tower_keeps_ln_pre_and_no_bias(self):
        cfg = port_config(CLIPConfig(name="v", vision=VisionConfig(
            kind="vit", image_size=32, patch_size=8, width=64, layers=1, heads=1,
            embed_dim=16), text=CFG.text))
        sd = tclip.init_clip_params(cfg)
        assert "visual.ln_pre.scale" in sd and "visual.conv1.bias" not in sd

    @pytest.mark.parametrize("kind", ["resnet", "video_vit"])
    def test_other_towers_still_refused(self, kind):
        cfg = port_config(CLIPConfig(name="x", vision=VisionConfig(
            kind=kind, image_size=32, patch_size=8, width=64, layers=1, heads=1,
            embed_dim=16), text=CFG.text))
        with pytest.raises(NotImplementedError, match="queue 1 item 4"):
            tclip.CLIP(cfg)


class TestFloat32:
    def test_exact_gelu_is_jax_erf_gelu(self):
        h = np.linspace(-6, 6, 4001).astype(np.float32)
        got = _np(tlayers.gelu(torch.from_numpy(h)))
        want = np.asarray(jax.nn.gelu(jnp.asarray(h), approximate=False))
        np.testing.assert_allclose(got, want, atol=1e-6)
        tanh = np.asarray(jax.nn.gelu(jnp.asarray(h), approximate=True))
        assert np.abs(got - tanh).max() > 1e-4  # not the tanh form

    def test_encode_image_vit(self, pair):
        jp, _, model = pair
        x = np.random.default_rng(1).normal(size=(3, 32, 32, 3)).astype(np.float32)
        ref = jclip.encode_image_vit(jp["visual"], jnp.asarray(x), CFG.vision)
        got = tclip.encode_image_vit(model.visual, torch.from_numpy(x))
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=F32_ATOL)

    def test_plain_tower_runs_exact_gelu(self, pair, monkeypatch):
        _, _, model = pair
        seen = []
        monkeypatch.setattr(tclip, "gelu", lambda h: seen.append(h.dtype) or tlayers.gelu(h))
        monkeypatch.setattr(fb, "erf_gelu", lambda h: pytest.fail("A&S polynomial used"))
        model.encode_image(torch.zeros(1, 32, 32, 3))
        assert seen == [torch.float32] * CFG.vision.layers

    def test_fold_carries_the_conv_bias(self, pair):
        jp, np_params, model = pair
        want = jclip.fold_preprocess_into_patch(jp["visual"]["conv1"], CFG.vision.image_mean,
                                                CFG.vision.image_std)
        got = tclip.fold_preprocess_into_patch(model.visual.conv1.kernel,
                                               CFG.vision.image_mean, CFG.vision.image_std,
                                               model.visual.conv1.bias)
        np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
        # the bias row sums 3 p^2 terms of magnitude ~5: float32 order noise
        np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]), rtol=1e-6, atol=1e-6)
        no_bias = tclip.fold_preprocess_into_patch(model.visual.conv1.kernel,
                                                   CFG.vision.image_mean, CFG.vision.image_std)
        np.testing.assert_allclose(_np(got[1] - no_bias[1]),
                                   np_params["visual"]["conv1"]["bias"], atol=1e-6)

    def test_p8_staging_with_folded_bias(self, pair):
        jp, _, model = pair
        p8 = patchify_u8(_u8(2), 8)
        ref = jclip.encode_image_vit_p8(jp["visual"], jnp.asarray(p8), CFG.vision,
                                        dtype=jnp.float32)
        got = model.encode_image(torch.from_numpy(p8), dtype=torch.float32)
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=F32_ATOL)

    def test_p8_equals_the_preprocessed_conv_stem(self, pair):
        """The folded stem on uint8 patches == the conv stem (with its bias)
        on the ImageNet-normalized images."""
        from debias_vision_lang_torch.vision.preprocess import preprocess_batch

        _, _, model = pair
        u8 = _u8(3)
        x = preprocess_batch(torch.from_numpy(u8), 32, mean=CFG.vision.image_mean,
                             std=CFG.vision.image_std)
        a = model.encode_image(x, dtype=torch.float32)
        b = model.encode_image(torch.from_numpy(patchify_u8(u8, 8)), dtype=torch.float32)
        np.testing.assert_allclose(_np(a), _np(b), atol=F32_ATOL)


def _jax_fused_interpret(monkeypatch):
    """Route JAX's fused tower through the Pallas kernels in interpret mode."""
    from debias_vision_lang_tpu.ops import fused_block as jfb

    monkeypatch.setattr(jfb, "fused_transformer_diff",
                        lambda p, x, heads, act_kind="quick_gelu", causal=False:
                        jfb.fused_transformer(p, x, heads, act_kind=act_kind, bb_attn=1,
                                              bb_mlp=1, interpret=True))


class TestBf16Fused:
    def test_tower_vs_jax_pallas_interpret(self, pair, monkeypatch):
        jp, _, model = pair
        _jax_fused_interpret(monkeypatch)
        p8 = patchify_u8(_u8(4, b=4), 8)
        ref = np.asarray(jclip.encode_image_vit_p8(jp["visual"], jnp.asarray(p8),
                                                   CFG.vision, dtype=jnp.bfloat16,
                                                   fused=True), np.float32)
        got = model.encode_image(torch.from_numpy(p8))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), ref, atol=2e-2, rtol=1e-2)
        assert _cos_rows(_np(got).ravel(), ref.ravel()) > 0.9999

    def test_fused_blocks_take_gelu(self, pair, monkeypatch):
        _, _, model = pair
        acts = []
        orig = fb.mlp_block
        monkeypatch.setattr(fb, "mlp_block",
                            lambda *a, **k: acts.append(k["act_kind"]) or orig(*a, **k))
        model.encode_image(torch.from_numpy(patchify_u8(_u8(5, b=2), 8)))
        assert acts == ["gelu"] * CFG.vision.layers
        assert all(v == 0 for v in fb.LAUNCHES.values())  # twins on the CPU

    def test_bf16_close_to_float32(self, pair):
        _, _, model = pair
        p8 = torch.from_numpy(patchify_u8(_u8(6), 8))
        assert _cos_rows(_np(model.encode_image(p8)),
                         _np(model.encode_image(p8, dtype=torch.float32))).min() >= 0.999


@pytest.fixture(scope="module")
def jquantized(pair):
    from debias_vision_lang_tpu.models.loader import CLIP as JCLIP

    jp, _, model = pair
    return jquant.QuantizedCLIP(JCLIP(params=jp, cfg=CFG)), tquant.QuantizedCLIP(model)


class TestInt8:
    def test_weight_codes_bit_exact(self, pair, jquantized):
        jq, tq = jquantized
        want, got = jq.visual_q, tq.visual_q
        for name in ("conv1", "conv1_folded"):
            for part in ("q", "scale"):
                np.testing.assert_array_equal(getattr(getattr(got, name), part).numpy(),
                                              np.asarray(want[name][part]))
        np.testing.assert_allclose(got.conv1_bias_folded.numpy(),  # a float32 sum
                                   np.asarray(want["conv1_bias_folded"]), rtol=1e-6,
                                   atol=1e-6)
        assert "ln_pre" not in want and "conv1_bias" in want
        for name, group in (("wqkv", "attn"), ("wo", "attn"), ("w1", "mlp"), ("w2", "mlp")):
            for part in ("q", "scale"):
                stacked = np.stack([getattr(getattr(blk, name), part).numpy()
                                    for blk in got.resblocks])
                np.testing.assert_array_equal(
                    stacked, np.asarray(want["resblocks"][group][name][part]))

    @pytest.mark.parametrize("stem", ["p8", "float"])
    def test_plain_float32_matches_jax_xla_int8(self, jquantized, stem):
        jq, tq = jquantized
        if stem == "p8":
            x = patchify_u8(_u8(7), 8)
        else:
            x = np.random.default_rng(8).normal(size=(3, 32, 32, 3)).astype(np.float32)
        want = jq.encode_image(jnp.asarray(x), dtype=jnp.float32)
        got = tq.encode_image(torch.from_numpy(x), dtype=torch.float32)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=XLA_INT8_ATOL)

    def test_plain_int8_runs_exact_gelu(self, jquantized, monkeypatch):
        _, tq = jquantized
        seen = []
        monkeypatch.setattr(tquant, "gelu", lambda h: seen.append(1) or tlayers.gelu(h))
        monkeypatch.setattr(fb, "erf_gelu", lambda h: pytest.fail("A&S polynomial used"))
        tq.encode_image(torch.from_numpy(patchify_u8(_u8(9, b=1), 8)), dtype=torch.float32)
        assert len(seen) == CFG.vision.layers

    def test_bf16_fused_twins_vs_jax(self, pair, jquantized, monkeypatch):
        jq, tq = jquantized
        _, _, model = pair
        acts = []
        orig = fbq.mlp_block_q
        monkeypatch.setattr(fbq, "mlp_block_q",
                            lambda *a, **k: acts.append(k["act_kind"]) or orig(*a, **k))
        p8 = patchify_u8(_u8(10), 8)
        want = np.asarray(jq.encode_image(jnp.asarray(p8)), np.float32)
        got = tq.encode_image(torch.from_numpy(p8))
        assert got.dtype == torch.bfloat16 and acts == ["gelu"] * CFG.vision.layers
        assert _cos_rows(_np(got), want).min() >= 0.999
        ref32 = model.encode_image(torch.from_numpy(p8), dtype=torch.float32)
        assert _cos_rows(_np(got), _np(ref32)).min() >= 0.999


@pytest.fixture(scope="module")
def fairface(tmp_path_factory):
    """Miniature FairFace layout (as tests/test_data_eval.py builds it)."""
    root = tmp_path_factory.mktemp("fairface_slip")
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


def tok(texts):
    """Deterministic toy tokenizer: SOT, two content ids, EOT (max id)."""
    out = np.zeros((len(texts), 77), np.int64)
    for i, t in enumerate(texts):
        b = t.encode()
        out[i, :4] = [510, sum(b) % 400 + 1, len(b) % 97 + 1, 511]
    return out


@pytest.fixture(scope="module")
def debias_models(pair):
    from debias_vision_lang_tpu.models.debias import DebiasCLIP as JDebiasCLIP

    jp, _, model = pair
    deb = np.random.default_rng(11).normal(size=(2, 64)).astype(np.float32)
    dcfg = DebiasConfig(num_debias_tokens=2, hidden_dim=64)
    jm = JDebiasCLIP(clip_params=jp, debias_tokens=jnp.asarray(deb), clip_cfg=CFG,
                     debias_cfg=dcfg)
    return jm, TDebiasCLIP(model, torch.from_numpy(deb), port_config(dcfg))


OPTS = {"batch_size": 8, "num_workers": 2, "topn": 10}


class TestMeasureBias:
    def test_float32_metrics_match_jax(self, fairface, debias_models):
        from debias_vision_lang_tpu.eval.measure import measure_bias
        from debias_vision_lang_tpu.vision.preprocess import Preprocess
        from debias_vision_lang_torch.eval.measure import measure_bias as tmeasure_bias
        from debias_vision_lang_torch.vision.preprocess import Preprocess as TPreprocess

        jm, tm = debias_models
        opts = {**OPTS, "data_path": fairface, "dtype": "float32"}
        stats = {"mean": CFG.vision.image_mean, "std": CFG.vision.image_std}
        want = measure_bias(jm, Preprocess(32, **stats), tok, "gender", opts=opts)
        got = tmeasure_bias(tm, TPreprocess(32, **stats), tok, "gender", opts=opts)
        assert set(got) == set(want) == {"maxskew", "ndkl"}
        for ev in want:
            for k in want[ev]:
                assert got[ev][k] == pytest.approx(want[ev][k], abs=1e-5)

    @pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
    def test_kernel_rungs_stage_p8_and_match_the_oracle(self, fairface, debias_models,
                                                        monkeypatch, dtype):
        from debias_vision_lang_torch.data import loader as tloader
        from debias_vision_lang_torch.eval import measure as tmeasure
        from debias_vision_lang_torch.vision.preprocess import Preprocess as TPreprocess

        _, tm = debias_models
        staged = []
        orig = tloader.HostLoader.__init__

        def spy(self, *a, **k):
            staged.append(k.get("native_patch"))
            orig(self, *a, **k)

        monkeypatch.setattr(tmeasure.HostLoader, "__init__", spy)
        opts = {**OPTS, "data_path": fairface, "dtype": dtype}
        stats = {"mean": CFG.vision.image_mean, "std": CFG.vision.image_std}
        got = tmeasure.measure_bias(tm, TPreprocess(32, **stats), tok, "gender", opts=opts)
        oracle = tmeasure.measure_bias(tm, TPreprocess(32, **stats), tok, "gender",
                                       opts={**opts, "engine": "oracle"})
        assert staged == [8, 8]  # patch-contiguous uint8 staging on this rung
        for ev in got:
            for k in got[ev]:
                assert np.isfinite(got[ev][k])
                assert got[ev][k] == pytest.approx(oracle[ev][k], abs=1e-5)


class TestGates:
    def test_serving_engine_stages_p8(self, pair):
        from debias_vision_lang_torch.serve.engine import InferenceEngine

        _, _, model = pair
        engine = InferenceEngine(model, tok, max_batch=4, compute_dtype="bfloat16",
                                 device="cpu")
        assert engine._patch == 8
        rows = engine.embed_image_arrays(list(_u8(12, b=4)))  # one full bucket
        want = model.encode_image(torch.from_numpy(patchify_u8(_u8(12, b=4), 8))).float()
        np.testing.assert_array_equal(np.asarray(rows), _np(want))

    def test_trainer_int8_embed_takes_slip(self, debias_models):
        from debias_vision_lang_torch.core.config import TrainConfig
        from debias_vision_lang_torch.models.adversary import Adversary
        from debias_vision_lang_torch.train.adversarial import AdversarialTrainer

        _, tm = debias_models
        sens = tok(["a", "b", "c"])
        adv = Adversary.from_cfg({"ADV_N_INPUT": 3, "ADV_HIDDEN_SIZE": 8, "SEED": 0})
        trainer = AdversarialTrainer.create(tm, adv, TrainConfig(embed_dtype="int8"), sens)
        imgs = np.random.default_rng(13).normal(size=(4, 32, 32, 3)).astype(np.float32)
        m = trainer.step(imgs, np.array([0, 1, 0, 1]), imgs[::-1].copy(),
                         tok(["w", "x", "y", "z"]))
        assert np.isfinite(m["loss"])

    def test_debias_from_cfg_builds_slip_b16(self):
        model, preprocess, _, alias = TDebiasCLIP.from_cfg(
            {"CLIP_ARCH": "facebookresearch/SLIP/ViT-B/16", "PRETRAINED": False},
            device="cpu")
        assert alias == "fb-slip-vit-b-16" and preprocess.n_px == 224
        assert model.clip.visual.ln_pre is None
        assert model.clip.visual.conv1.bias.shape == (768,)
        assert tuple(preprocess.mean) == (0.485, 0.456, 0.406)
