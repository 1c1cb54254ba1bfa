"""Towers, weight bridge, prompt injection and preprocess of the PyTorch port
against the JAX package, on the CPU at a tiny size.

The same weights (a seeded init in the JAX package's pytree layout, perturbed
so every bias and LayerNorm is non-trivial) and the same numpy inputs go
through both packages.  Towers:
float32 at atol 1e-4; bfloat16 (the port's fused twins vs JAX's bf16 XLA
path) at cosine >= 0.999.  Injection and host preprocess: bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debias_vision_lang_tpu.core.config import (CLIPConfig, DebiasConfig,
                                                TextConfig, VisionConfig)
from debias_vision_lang_tpu.models import clip as jclip
from debias_vision_lang_tpu.models import debias as jdebias
from debias_vision_lang_tpu.vision import preprocess as jpre
from debias_vision_lang_torch.models import clip as tclip
from debias_vision_lang_torch.models import debias as tdebias
from debias_vision_lang_torch.models.convert import (params_from_jax,
                                                     params_from_openai_state_dict,
                                                     to_jax_tree)
from debias_vision_lang_torch.ops import fused_block as fb
from debias_vision_lang_torch.vision import preprocess as tpre
from torch_port_config import port_config

torch.set_num_threads(1)

CFG = CLIPConfig(
    name="tiny",
    vision=VisionConfig(kind="vit", image_size=32, patch_size=8, width=64,
                        layers=2, heads=2, embed_dim=32),
    text=TextConfig(vocab_size=512, context_length=16, width=32, layers=2,
                    heads=2, embed_dim=32))
TCFG = port_config(CFG)  # the port's own config object, same fields


@pytest.fixture(scope="module")
def pair():
    """(JAX params, numpy params, port CLIP) holding the same weights."""
    rng = np.random.default_rng(0)
    np_params = jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        to_jax_tree(tclip.init_clip_params(TCFG, torch.Generator().manual_seed(0))))
    model = tclip.CLIP(TCFG)
    model.load_state_dict(params_from_jax(np_params, TCFG))
    return jax.tree.map(jnp.asarray, np_params), np_params, model


def _tokens(rng, b=4, s=16, vocab=512, eot_at=None):
    ids = rng.integers(1, vocab - 2, size=(b, s))
    eot = eot_at if eot_at is not None else rng.integers(2, s, size=b)
    for i, e in enumerate(eot):
        ids[i, 0] = vocab - 2
        ids[i, e] = vocab - 1
        ids[i, e + 1:] = 0
    return ids.astype(np.int64)


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _np(t):
    return t.detach().float().numpy()


class TestWeightBridge:
    def test_every_parameter_unstacked(self, pair):
        _, np_params, model = pair
        rb = np_params["visual"]["resblocks"]
        np.testing.assert_array_equal(_np(model.visual.resblocks[1].attn.wqkv),
                                      rb["attn"]["wqkv"][1])
        np.testing.assert_array_equal(_np(model.text.resblocks[0].mlp.w2),
                                      np_params["text"]["resblocks"]["mlp"]["w2"][0])
        np.testing.assert_array_equal(_np(model.visual.conv1.kernel),
                                      np_params["visual"]["conv1"]["kernel"])
        assert float(model.logit_scale.detach()) == pytest.approx(
            float(np_params["logit_scale"]))

    def test_tree_matches_jax_init_structure(self, pair):
        _, np_params, _ = pair
        ref = jax.eval_shape(lambda: jclip.init_clip_params(jax.random.key(0), CFG))
        assert jax.tree.structure(ref) == jax.tree.structure(np_params)
        jax.tree.map(lambda r, a: r.shape == a.shape or pytest.fail(str(r.shape)),
                     ref, np_params)

    def test_openai_layout_transposes_once(self, pair):
        from debias_vision_lang_tpu.models.convert import to_openai_state_dict

        _, np_params, model = pair
        via_openai = params_from_openai_state_dict(to_openai_state_dict(np_params, CFG))
        want = model.state_dict()
        assert set(via_openai) == set(want)
        for k, v in via_openai.items():
            torch.testing.assert_close(v, want[k], rtol=0, atol=0)

    def test_loader_reads_openai_npz(self, pair, tmp_path):
        from debias_vision_lang_tpu.models.convert import to_openai_state_dict
        from debias_vision_lang_torch.models.loader import _load_weights_file

        _, np_params, model = pair
        path = tmp_path / "w.npz"
        np.savez(path, **to_openai_state_dict(np_params, CFG))
        got = _load_weights_file(str(path))
        for k, v in model.state_dict().items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)


class TestTowersF32:
    def test_encode_image_vit(self, pair):
        jp, _, model = pair
        x = np.random.default_rng(1).normal(size=(3, 32, 32, 3)).astype(np.float32)
        ref = jclip.encode_image_vit(jp["visual"], jnp.asarray(x), CFG.vision)
        got = tclip.encode_image_vit(model.visual, torch.from_numpy(x))
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-4)

    def test_encode_image_vit_p8(self, pair):
        jp, _, model = pair
        u8 = np.random.default_rng(2).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
        p8 = tpre.patchify_u8(u8, 8)
        ref = jclip.encode_image_vit_p8(jp["visual"], jnp.asarray(p8), CFG.vision,
                                        dtype=jnp.float32)
        got = model.encode_image(torch.from_numpy(p8), dtype=torch.float32)
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-4)

    def test_text_tower_piecewise(self, pair):
        jp, _, model = pair
        ids = _tokens(np.random.default_rng(3))
        jt, tt = jp["text"], model.text
        j_x = jclip.add_positional(jt, jclip.embed_tokens(jt, jnp.asarray(ids)))
        t_x = tclip.add_positional(tt, tclip.embed_tokens(tt, torch.from_numpy(ids)))
        np.testing.assert_array_equal(_np(t_x), np.asarray(j_x))
        j_y = jclip.run_text_transformer(jt, j_x, CFG.text)
        t_y = tclip.run_text_transformer(tt, t_x)
        np.testing.assert_allclose(_np(t_y), np.asarray(j_y), atol=1e-4)
        np.testing.assert_allclose(
            _np(tclip.project_eot(tt, t_y, torch.from_numpy(ids))),
            np.asarray(jclip.project_eot(jt, j_y, jnp.asarray(ids))), atol=1e-4)
        np.testing.assert_allclose(
            _np(model.encode_text(torch.from_numpy(ids))),
            np.asarray(jclip.encode_text(jp, jnp.asarray(ids), CFG)), atol=1e-4)


class TestTowersBf16:
    def test_image_tower_vs_jax_bf16(self, pair):
        jp, _, model = pair
        u8 = np.random.default_rng(4).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
        p8 = tpre.patchify_u8(u8, 8)
        ref = jclip.encode_image_vit_p8(jp["visual"], jnp.asarray(p8), CFG.vision,
                                        dtype=jnp.bfloat16)
        got = model.encode_image(torch.from_numpy(p8))
        assert got.dtype == torch.bfloat16
        assert _cos(_np(got), np.asarray(ref, np.float32)) >= 0.999

    def test_bf16_text_tower_goes_through_causal_block(self, pair, monkeypatch):
        _, _, model = pair
        calls = []
        orig = fb.attention_block

        def spy(*a, **kw):
            calls.append(kw["causal"])
            return orig(*a, **kw)

        monkeypatch.setattr(fb, "attention_block", spy)
        ids = torch.from_numpy(_tokens(np.random.default_rng(5)))
        got = model.encode_text(ids, dtype=torch.bfloat16)
        assert calls == [True] * CFG.text.layers
        assert _cos(_np(got), _np(model.encode_text(ids))) >= 0.999

    def test_fused_false_runs_plain_bf16(self, pair):
        _, _, model = pair
        p8 = torch.from_numpy(tpre.patchify_u8(
            np.random.default_rng(6).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8), 8))
        fused = model.encode_image(p8)
        plain = model.encode_image(p8, fused=False)
        assert _cos(_np(fused), _np(plain)) >= 0.999


MODES = ["prepend", "append", "append_after_eos", "add"]


class TestInjection:
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("p", [0, 2])
    def test_inject_bit_exact(self, mode, p):
        rng = np.random.default_rng(7)
        raw = rng.normal(size=(4, 16, 32)).astype(np.float32)
        deb = rng.normal(size=(p, 32)).astype(np.float32)
        ids = _tokens(rng, eot_at=[3, 10, 14, 15])  # EOT at the last slot clamps
        ref = jdebias.inject_prompts(jnp.asarray(raw), jnp.asarray(deb),
                                     jnp.asarray(ids), mode)
        got = tdebias.inject_prompts(torch.from_numpy(raw), torch.from_numpy(deb),
                                     torch.from_numpy(ids), mode)
        np.testing.assert_array_equal(_np(got), np.asarray(ref))
        np.testing.assert_array_equal(
            tdebias.debias_eot_index(torch.from_numpy(ids), p, 16).numpy(),
            np.asarray(jdebias.debias_eot_index(jnp.asarray(ids), p, 16)))

    @pytest.mark.parametrize("mode", MODES)
    def test_debias_encode_text(self, pair, mode):
        jp, _, model = pair
        dcfg = DebiasConfig(num_debias_tokens=2, hidden_dim=32, debias_pos=mode)
        deb = np.random.default_rng(8).normal(size=(2, 32)).astype(np.float32)
        ids = _tokens(np.random.default_rng(9), eot_at=[3, 10, 14, 15])
        ref = jdebias.encode_text(jp, jnp.asarray(deb), jnp.asarray(ids), CFG, dcfg)
        port = tdebias.DebiasCLIP(model, torch.from_numpy(deb), port_config(dcfg))
        got = port.encode_text(torch.from_numpy(ids))
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-4)

    def test_zeros_init_is_token_zero_embedding(self, pair):
        _, _, model = pair
        tokens = tdebias.init_debias_tokens(model, port_config(DebiasConfig(hidden_dim=32)))
        torch.testing.assert_close(tokens, model.text.token_embedding[0].detach()
                                   .expand(2, 32), rtol=0, atol=0)


class TestFromCfg:
    def test_vit_b16_random_init(self):
        model, preprocess, _, alias = tdebias.DebiasCLIP.from_cfg(
            {"CLIP_ARCH": "openai/CLIP/ViT-B/16", "PRETRAINED": False, "SEED": 3},
            device="cpu")
        assert alias == "oai-clip-vit-b-16"
        assert model.debias_tokens.shape == (2, 512)
        assert preprocess.n_px == 224
        assert len(model.clip.visual.resblocks) == 12

    @pytest.mark.parametrize("name", ["not/a/model"])
    def test_unported_or_unknown_arch_raises(self, name):
        with pytest.raises(NotImplementedError):
            tdebias.DebiasCLIP.from_cfg({"CLIP_ARCH": name, "PRETRAINED": False},
                                        device="cpu")

    @pytest.mark.parametrize("name", ["openai/CLIP/RN50", "openai/CLIP/RN50x4"])
    def test_resnet_archs_build(self, name):
        from debias_vision_lang_torch.models.resnet import ModifiedResNet

        model, preprocess, _, _ = tdebias.DebiasCLIP.from_cfg(
            {"CLIP_ARCH": name, "PRETRAINED": False}, device="cpu")
        assert isinstance(model.clip.visual, ModifiedResNet)
        assert preprocess.n_px == model.clip_cfg.vision.image_size
        assert model.debias_tokens.shape == (2, model.clip_cfg.text.width)


class TestPreprocess:
    def test_host_chain_bit_exact(self):
        img = np.random.default_rng(10).integers(0, 256, (40, 52, 3), dtype=np.uint8)
        np.testing.assert_array_equal(tpre.resize_crop_u8(img, 32),
                                      jpre.resize_crop_u8(img, 32))
        np.testing.assert_array_equal(tpre.preprocess_host_exact(img, 32),
                                      jpre.preprocess_host_exact(img, 32))
        np.testing.assert_array_equal(tpre.patchify_u8(img[:32, :32], 8),
                                      jpre.patchify_u8(img[:32, :32], 8))

    def test_device_chain_matches(self):
        imgs = np.random.default_rng(11).integers(0, 256, (2, 24, 40, 3), dtype=np.uint8)
        ref = jpre.preprocess_batch(jnp.asarray(imgs), 32)
        got = tpre.preprocess_batch(torch.from_numpy(imgs), 32)
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-4)

    def test_preprocess_callable_matches(self):
        img = np.random.default_rng(12).integers(0, 256, (30, 36, 3), dtype=np.uint8)
        np.testing.assert_array_equal(tpre.Preprocess(32)(img), jpre.Preprocess(32)(img))
