"""The Frozen-in-Time video family (``video_vit``) in the PyTorch port
against the JAX package, on the CPU at a tiny size (32 px, patch 8, width
32, 2 layers, 2 heads, 4 frames, as tests/test_quant_video.py builds it).

The JAX init zeroes the temporal embedding and every temporal out-projection
(``wo``, ``bo``), which would run the divided tower's temporal attention as
the identity: the shared weights redraw them from a seeded generator, and
perturb every other leaf, so each LayerNorm and bias is non-trivial.

Bars: the parameter tree equal to ``jax.eval_shape(init_fit_params)`` at the
registry's full widths, and the weight bridge exact; float32 towers (joint,
divided, and with ``use_pallas=True``) within 1e-5 x max(1, max |JAX|);
bfloat16 towers at cosine >= 0.9999 against JAX's bf16 towers; the 4-D
promotion and the frame subsample bit-equal (the indices for t = 5..64
bit-equal to ``jnp.linspace(...).astype(int32)``); the m-bain converter
exact and its forward within 1e-5; the loader's joint / divided choice and
the freezing policy equal to JAX's.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debias_vision_lang_tpu.core.config import (CLIPConfig, DebiasConfig,
                                                TextConfig, VisionConfig)
from debias_vision_lang_tpu.models import frozen_in_time as jfit
from debias_vision_lang_torch.models import clip as tclip
from debias_vision_lang_torch.models import frozen_in_time as tfit
from debias_vision_lang_torch.models import loader as tloader
from debias_vision_lang_torch.models.convert import (from_fit_state_dict, params_from_jax,
                                                     to_jax_tree)
from debias_vision_lang_torch.models.debias import DebiasCLIP as TDebiasCLIP
from torch_port_config import port_config

torch.set_num_threads(1)

T_FRAMES = 4


def fit_cfg(attention="joint"):
    return CLIPConfig(
        name="tiny-fit",
        vision=VisionConfig(kind="video_vit", image_size=32, patch_size=8, width=32,
                            layers=2, heads=2, embed_dim=16, video_attention=attention,
                            image_mean=(0.485, 0.456, 0.406),
                            image_std=(0.229, 0.224, 0.225)),
        text=TextConfig(vocab_size=128, context_length=16, width=32, layers=1, heads=2,
                        embed_dim=16))


CFG = fit_cfg()
TCFG = port_config(CFG)


def fit_params_np(cfg=CFG, seed=0):
    """JAX-initialised FiT params as numpy, every leaf perturbed, and the
    temporal embedding and temporal out-projections redrawn away from
    zero."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        jfit.init_fit_params(jax.random.key(seed), cfg, num_frames=T_FRAMES))
    v, w = p["visual"], cfg.vision.width
    v["temporal_embedding"] = rng.normal(size=(T_FRAMES, w)).astype(np.float32) * 0.5
    ta = v["temporal_attn"]["attn"]
    ta["wo"] = (rng.normal(size=ta["wo"].shape) * w ** -0.5).astype(np.float32)
    ta["bo"] = (rng.normal(size=ta["bo"].shape) * 0.1).astype(np.float32)
    return p


def port_model(np_params, cfg=TCFG, attention=None):
    model = tfit.FrozenInTime(cfg, attention)
    model.load_state_dict(params_from_jax(np_params, cfg))
    return model.eval()


@pytest.fixture(scope="module")
def pair():
    np_params = fit_params_np()
    return jax.tree.map(jnp.asarray, np_params), np_params, port_model(np_params)


@pytest.fixture(scope="module")
def videos():
    return np.random.default_rng(3).normal(size=(3, T_FRAMES, 32, 32, 3)).astype(np.float32)


def _np(t):
    return np.asarray(t.detach().float() if torch.is_tensor(t) else t, np.float32)


def _close(got, want, tol=1e-5):
    got, want = _np(got), _np(want)
    bar = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bar, f"max err {err} > {bar}"


def _cos_rows(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


JAX_ENCODE = {"joint": jfit.encode_video, "divided": jfit.encode_video_divided}


def _jax_tower(jp, x, mode, dtype=jnp.float32, **kw):
    return JAX_ENCODE[mode](jp["visual"], jnp.asarray(x), CFG.vision, dtype=dtype, **kw)


def _port_tower(model, x, mode, dtype=torch.float32, **kw):
    with torch.no_grad():
        return model.visual(torch.from_numpy(np.asarray(x)), dtype=dtype, attention=mode, **kw)


class TestTree:
    def test_full_width_names_and_shapes_equal_jax(self):
        from debias_vision_lang_tpu.core.registry import resolve_arch as jresolve
        from debias_vision_lang_torch.core.registry import resolve_arch

        name = "m-bain/frozen-in-time/base"
        want = jax.eval_shape(lambda: jfit.init_fit_params(jax.random.key(0), jresolve(name)))
        sd = tclip.init_clip_params(resolve_arch(name))
        got = to_jax_tree(sd)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        jax.tree.map(lambda w, g: w.shape == g.shape or pytest.fail(str(w.shape)), want, got)
        assert sd["visual.temporal_attn.attn.wqkv"].shape == (12, 768, 3 * 768)
        assert sd["visual.proj.kernel"].shape == (768, 256)

    def test_init_is_the_identity_init(self):
        sd = tfit.init_fit_params(TCFG, torch.Generator().manual_seed(1))
        for k in ("visual.temporal_embedding", "visual.temporal_attn.attn.wo",
                  "visual.temporal_attn.attn.bo", "visual.temporal_attn.attn.bqkv",
                  "visual.conv1.bias", "visual.proj.bias"):
            assert float(sd[k].abs().max()) == 0.0, k
        assert float(sd["visual.temporal_attn.attn.wqkv"].abs().max()) > 0
        assert torch.equal(sd["visual.temporal_attn.ln_t.scale"], torch.ones(2, 32))

    def test_params_from_jax_exact(self, pair):
        _, np_params, model = pair
        back = to_jax_tree(model.state_dict())
        jax.tree.map(np.testing.assert_array_equal, back, np_params)

    def test_tower_kind_and_unknown_kinds(self):
        assert tloader.tower_kind(params_from_jax(fit_params_np(), TCFG)) == "video_vit"
        cfg = dataclasses.replace(TCFG, vision=dataclasses.replace(TCFG.vision, kind="swin"))
        with pytest.raises(NotImplementedError, match="the port builds vit, slip_vit, "
                                                      "resnet, video_vit"):
            tclip.CLIP(cfg)


class TestTowersFloat32:
    @pytest.mark.parametrize("mode", ["joint", "divided"])
    def test_tower_matches_jax(self, pair, videos, mode):
        jp, _, model = pair
        _close(_port_tower(model, videos, mode), _jax_tower(jp, videos, mode))

    @pytest.mark.parametrize("mode", ["joint", "divided"])
    def test_use_pallas_matches_jax(self, pair, videos, mode):
        """use_pallas=True sends each attention to the attention op (its twin
        on the CPU): the same function."""
        jp, _, model = pair
        _close(_port_tower(model, videos, mode, use_pallas=True),
               _jax_tower(jp, videos, mode))

    @pytest.mark.parametrize("mode", ["joint", "divided"])
    def test_fused_is_ignored(self, pair, videos, mode):
        _, _, model = pair
        torch.testing.assert_close(_port_tower(model, videos, mode, fused=True),
                                   _port_tower(model, videos, mode), rtol=0, atol=0)

    @pytest.mark.parametrize("mode", ["joint", "divided"])
    def test_remat_is_the_same_function(self, pair, videos, mode):
        _, np_params, _ = pair
        outs = []
        for remat in (False, True):
            model = port_model(np_params)
            out = model.visual(torch.from_numpy(videos[:2]), attention=mode, remat=remat)
            out.square().sum().backward()
            outs.append((out.detach(), model.visual.conv1.kernel.grad.clone()))
        torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
        torch.testing.assert_close(outs[0][1], outs[1][1], rtol=1e-6, atol=1e-7)

    def test_bundle_runs_its_attention(self, pair, videos):
        """FrozenInTime.encode_image runs its ``attention``; a plain CLIP over
        the same config runs cfg.vision.video_attention."""
        _, np_params, model = pair
        x = torch.from_numpy(videos)
        divided = port_model(np_params, attention="divided")
        with torch.no_grad():
            assert torch.equal(divided.encode_image(x), _port_tower(model, videos, "divided"))
            assert torch.equal(divided.encode_video(x), divided.encode_image(x))
            assert torch.equal(model.encode_image(x), _port_tower(model, videos, "joint"))
            cfg = port_config(fit_cfg("divided"))
            clip = tclip.CLIP(cfg)
            clip.load_state_dict(params_from_jax(np_params, cfg))
            assert torch.equal(clip.encode_image(x), divided.encode_image(x))
        with pytest.raises(ValueError, match="'joint' or 'divided'"):
            tfit.FrozenInTime(TCFG, "spatial")


class TestTowersBfloat16:
    @pytest.mark.parametrize("mode", ["joint", "divided"])
    def test_cosine_against_jax_bf16(self, pair, videos, mode):
        jp, _, model = pair
        got = _port_tower(model, videos, mode, dtype=torch.bfloat16)
        want = _jax_tower(jp, videos, mode, dtype=jnp.bfloat16)
        assert got.dtype == torch.bfloat16
        assert _cos_rows(_np(got), _np(want)).min() >= 0.9999


class TestVideoInput:
    def test_4d_promotion_is_bit_equal(self, pair, videos):
        _, _, model = pair
        for mode in ("joint", "divided"):
            frames = videos[:, 0]
            torch.testing.assert_close(_port_tower(model, frames, mode),
                                       _port_tower(model, frames[:, None], mode),
                                       rtol=0, atol=0)

    @pytest.mark.parametrize("max_t", [4, 2, 8])
    def test_frame_indices_bit_equal(self, max_t):
        for t in range(max_t + 1, 65):
            want = np.asarray(jnp.linspace(0, t - 1, max_t).astype(jnp.int32))
            np.testing.assert_array_equal(tfit.frame_indices(t, max_t).numpy(), want)

    def test_subsample_matches_jax(self, pair):
        jp, _, model = pair
        six = np.random.default_rng(6).normal(size=(2, 6, 32, 32, 3)).astype(np.float32)
        idx = tfit.frame_indices(6, T_FRAMES).numpy()
        assert list(idx) == [0, 1, 3, 5]
        for mode in ("joint", "divided"):
            got = _port_tower(model, six, mode)
            torch.testing.assert_close(got, _port_tower(model, six[:, idx], mode),
                                       rtol=0, atol=0)
            _close(got, _jax_tower(jp, six, mode))

    def test_shorter_video_takes_the_first_embeddings(self, pair):
        jp, _, model = pair
        two = np.random.default_rng(7).normal(size=(2, 2, 32, 32, 3)).astype(np.float32)
        for mode in ("joint", "divided"):
            _close(_port_tower(model, two, mode), _jax_tower(jp, two, mode))

    def test_zero_temporal_path_is_the_identity(self, videos):
        """With the temporal out-projection zero (the init), the divided
        tower's temporal attention adds nothing, whatever its QKV holds."""
        np_params = fit_params_np()
        ta = np_params["visual"]["temporal_attn"]["attn"]
        ta["wo"][:] = 0
        ta["bo"][:] = 0
        base = _port_tower(port_model(np_params), videos, "divided")
        ta["wqkv"] += 1.0
        np_params["visual"]["temporal_attn"]["ln_t"]["bias"] += 0.5
        torch.testing.assert_close(_port_tower(port_model(np_params), videos, "divided"),
                                   base, rtol=0, atol=0)

    def test_state_dict_without_temporal_embedding(self, pair, videos):
        """As the JAX bundle's __post_init__: a zero temporal embedding."""
        _, np_params, _ = pair
        sd = params_from_jax(np_params, TCFG)
        del sd["visual.temporal_embedding"]
        model = tfit.FrozenInTime(TCFG)
        model.load_state_dict(sd)
        assert torch.equal(model.visual.temporal_embedding, torch.zeros(T_FRAMES, 32))


# ---------------------------------------------------------------------------
# m-bain checkpoints and the loader
# ---------------------------------------------------------------------------

W, L, P, IMG, E = 32, 2, 8, 32, 16


def fit_state_dict(zero_time_proj=False, seed=7):
    """An m-bain/frozen-in-time state dict (module. prefixes) with the
    DistilBERT text side the converter skips."""
    rng = np.random.default_rng(seed)
    n_tok = (IMG // P) ** 2 + 1
    shapes = {
        "video_model.cls_token": (1, 1, W), "video_model.pos_embed": (1, n_tok, W),
        "video_model.temporal_embed": (1, T_FRAMES, W),
        "video_model.patch_embed.proj.weight": (W, 3, P, P),
        "video_model.patch_embed.proj.bias": (W,),
        "video_model.norm.weight": (W,), "video_model.norm.bias": (W,),
        "vid_proj.0.weight": (E, W), "vid_proj.0.bias": (E,),
        "text_model.embeddings.word_embeddings.weight": (64, 4), "txt_proj.0.weight": (E, 4),
    }
    for i in range(L):
        b = f"video_model.blocks.{i}"
        for nm in ("norm1", "norm2", "norm3"):
            shapes[f"{b}.{nm}.weight"] = shapes[f"{b}.{nm}.bias"] = (W,)
        for nm in ("attn", "timeattn"):
            shapes[f"{b}.{nm}.qkv.weight"], shapes[f"{b}.{nm}.qkv.bias"] = (3 * W, W), (3 * W,)
            shapes[f"{b}.{nm}.proj.weight"], shapes[f"{b}.{nm}.proj.bias"] = (W, W), (W,)
        shapes[f"{b}.mlp.fc1.weight"], shapes[f"{b}.mlp.fc1.bias"] = (4 * W, W), (4 * W,)
        shapes[f"{b}.mlp.fc2.weight"], shapes[f"{b}.mlp.fc2.bias"] = (W, 4 * W), (W,)
    sd = {k: (0.1 * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
    for k in sd:
        if k.endswith(("norm1.weight", "norm2.weight", "norm3.weight", "norm.weight")):
            sd[k] += 1.0
        if zero_time_proj and ".timeattn.proj." in k:
            sd[k][:] = 0
    return {f"module.{k}": v for k, v in sd.items()}


class TestConverter:
    def test_params_equal_jax(self):
        from debias_vision_lang_tpu.models.convert import from_fit_state_dict as jconv

        sd = fit_state_dict()
        want = jax.tree.map(np.asarray, jconv({"state_dict": sd}))
        got = from_fit_state_dict({"state_dict": sd})
        assert not any(k.startswith("text.") for k in got)
        assert set(got) == set(params_from_jax(want, TCFG))
        jax.tree.map(np.testing.assert_array_equal, to_jax_tree(got), want)
        assert float(got["logit_scale"]) == float(want["logit_scale"])
        assert torch.equal(got["visual.ln_pre.scale"], torch.ones(W))

    @pytest.mark.parametrize("mode", ["joint", "divided"])
    def test_forward_matches_jax(self, videos, mode):
        from debias_vision_lang_tpu.models.convert import from_fit_state_dict as jconv

        sd = fit_state_dict()
        jp = jconv(sd)
        visual = {k: v for k, v in from_fit_state_dict(sd).items() if k.startswith("visual.")}
        model = tfit.FrozenInTime(TCFG)
        model.visual.load_state_dict({k[len("visual."):]: v for k, v in visual.items()})
        _close(_port_tower(model, videos, mode), _jax_tower(jp, videos, mode))

    @pytest.mark.parametrize("zero", [False, True])
    def test_loader_choice_equals_jax(self, tmp_path, monkeypatch, zero):
        """A trained temporal out-projection runs "divided", a zero one
        "joint", in both packages, with the text tower drawn at random."""
        from debias_vision_lang_tpu.models import loader as jloader

        path = str(tmp_path / "fit.pt")
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in
                                   fit_state_dict(zero_time_proj=zero).items()}}, path)
        monkeypatch.setattr(jloader, "resolve_arch", lambda name: CFG)
        monkeypatch.setattr(tloader, "resolve_arch", lambda name: TCFG)
        name = "m-bain/frozen-in-time/base"
        with pytest.warns(UserWarning, match="no text tower"):
            jm = jloader.model_loader(name, weights=path)[0]
        with pytest.warns(UserWarning, match="no text tower"):
            tm = tloader.model_loader(name, device="cpu", weights=path)[0]
        want = "joint" if zero else "divided"
        assert jm.attention == jm.cfg.vision.video_attention == want
        assert isinstance(tm, tfit.FrozenInTime)
        assert tm.attention == tm.cfg.vision.video_attention == want
        assert tloader._temporal_attn_trained(tm.state_dict()) is (not zero)
        assert jloader._temporal_attn_trained(jm.params) is (not zero)

    def test_fresh_init_is_joint(self, monkeypatch):
        monkeypatch.setattr(tloader, "resolve_arch", lambda name: TCFG)
        m, pre, _, alias = tloader.model_loader("m-bain/frozen-in-time/base", device="cpu",
                                                pretrained=False)
        assert isinstance(m, tfit.FrozenInTime) and m.attention == "joint"
        assert alias == "mbain-fit-base" and pre.n_px == 32

    def test_dispatch_sends_video_names_to_the_converter(self):
        sd = fit_state_dict()
        got = tloader._dispatch_state_dict({"state_dict": sd}, TCFG)
        assert tloader.tower_kind(got) == "video_vit"
        with pytest.raises(ValueError, match="'video_vit' image tower"):
            tloader._dispatch_state_dict(sd, port_config(dataclasses.replace(
                CFG, vision=dataclasses.replace(CFG.vision, kind="vit"))))


# ---------------------------------------------------------------------------
# DebiasCLIP over a Frozen-in-Time tower
# ---------------------------------------------------------------------------


class TestDebiasWrapper:
    @pytest.fixture
    def both(self, pair):
        _, np_params, _ = pair
        jtree = jax.tree.map(jnp.asarray, np_params)
        return jtree, port_model(np_params)

    def test_layer_counts_equal_jax(self, both):
        from debias_vision_lang_tpu.models.debias import layer_counts as jcounts
        from debias_vision_lang_torch.models.debias import layer_counts

        tree, model = both
        assert layer_counts(model) == jcounts(tree) == {"image": 2, "text": 1}

    def test_classify_params_equal_jax(self, both):
        from debias_vision_lang_tpu.models.debias import classify_params as jclassify
        from debias_vision_lang_torch.models.debias import classify_params

        tree, model = both
        jmeta, jclassed = jclassify(tree)
        meta, classed = classify_params(model)
        assert meta == jmeta
        jtypes = {c["name"].replace("/", "."): c["type"] for c in jclassed}
        types = {c["name"]: c["type"] for c in classed}
        outside = {k: v for k, v in types.items() if ".resblocks." not in k}
        assert outside == {k: v for k, v in jtypes.items() if ".resblocks" not in k}
        assert types["visual.proj.kernel"] == "other"  # JAX's exact visual/proj test

    @pytest.mark.parametrize("n_vid", [0, 1, 2])
    @pytest.mark.parametrize("freeze_proj", [True, False])
    def test_trainable_mask_equals_jax(self, both, n_vid, freeze_proj):
        from debias_vision_lang_tpu.models.debias import trainable_mask as jmask
        from debias_vision_lang_torch.models.debias import trainable_mask

        tree, model = both
        dcfg = DebiasConfig(n_train_vid_layers=n_vid, n_train_text_layers=1,
                            freeze_proj=freeze_proj)
        got = trainable_mask(model, port_config(dcfg))
        want = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(jmask(tree, dcfg))[0]:
            name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            leaf = np.asarray(leaf)
            tower, sep, rest = name.partition(".resblocks.")
            for i in range(leaf.shape[0]) if sep else [None]:
                key = f"{tower}.resblocks.{i}.{rest}" if sep else name
                want[key] = float((leaf[i] if sep else leaf).reshape(-1)[0])
        assert got == want
        assert got["visual.proj.kernel"] == (0.0 if freeze_proj else 1.0)

    def test_from_cfg_builds_a_fit(self, monkeypatch, videos):
        from debias_vision_lang_torch.models.debias import DebiasCLIP

        monkeypatch.setattr(tloader, "resolve_arch", lambda name: TCFG)
        model, pre, _, alias = DebiasCLIP.from_cfg(
            {"CLIP_ARCH": "m-bain/frozen-in-time/base", "NUM_DEBIAS_TOKENS": 2,
             "PRETRAINED": False}, device="cpu")
        assert isinstance(model.clip, tfit.FrozenInTime) and alias == "mbain-fit-base"
        assert model.debias_tokens.shape == (2, 32)
        with torch.no_grad():
            five = model.encode_image(torch.from_numpy(videos))
            four = model.encode_image(torch.from_numpy(videos[:, 0]))
        assert five.shape == four.shape == (3, 16)
        assert isinstance(model, TDebiasCLIP)


# ---------------------------------------------------------------------------
# run_training on a Frozen-in-Time DebiasCLIP, and an OpenAI image-ViT file
# under a Frozen-in-Time arch, both against the JAX package
# ---------------------------------------------------------------------------

LOOP_PROMPTS = ["a good person", "a bad person"]


def loop_tok(texts):
    out = np.zeros((len(texts), 16), np.int64)
    out[:, 0] = 126
    for i, t in enumerate(texts):
        out[i, 1] = sum(t.encode()) % 100 + 1
        out[i, 2] = 127
    return out


@pytest.fixture(scope="module")
def loop_fairface(tmp_path_factory):
    """16 train = val rows of 32 px images, balanced gender."""
    import pandas as pd
    from PIL import Image

    root = tmp_path_factory.mktemp("fit_loop")
    img_dir = root / "imgs" / "train_val" / "x"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    rows = []
    for i in range(16):
        Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(
            img_dir / f"{i}.png")
        rows.append({"file": f"x/{i}.png", "age": "20-29",
                     "gender": "Male" if i % 2 else "Female", "race": "White"})
    for mode in ("train", "val"):
        (root / "labels" / mode).mkdir(parents=True)
        pd.DataFrame(rows).to_csv(root / "labels" / mode / f"{mode}_labels.csv", index=False)
    return str(root)


class TestRunTraining:
    """``run_training`` on a Frozen-in-Time DebiasCLIP in both packages, from
    the same weights, prompt tokens, adversary and FairFace images (4-D
    batches, each promoted to a one-frame video, as JAX's ``encode_image``
    does): 2 steps, every logged loss and the exported tokens within
    1e-5 x max(1, |JAX|), the bar of tests/test_torch_train.py."""

    @pytest.mark.parametrize("mode", ["joint", "divided"])
    def test_two_steps_equal_jax(self, loop_fairface, tmp_path, monkeypatch, mode):
        import json

        from debias_vision_lang_tpu.core.config import TrainConfig
        from debias_vision_lang_tpu.models.adversary import Adversary as JAdversary
        from debias_vision_lang_tpu.models.debias import DebiasCLIP as JDebiasCLIP
        from debias_vision_lang_tpu.train.loop import run_training as jrun
        from debias_vision_lang_torch.models.adversary import Adversary
        from debias_vision_lang_torch.models.convert import adversary_params_from_jax
        from debias_vision_lang_torch.train.loop import run_training as trun

        cfg = fit_cfg(mode)
        np_params = fit_params_np(cfg)
        tokens = np.random.default_rng(1).normal(size=(2, 32)).astype(np.float32) * 0.02
        dcfg = DebiasConfig(num_debias_tokens=2, hidden_dim=32, max_tokens=16)
        jmodel = JDebiasCLIP(clip_params=jax.tree.map(jnp.asarray, np_params),
                             debias_tokens=jnp.asarray(tokens), clip_cfg=cfg, debias_cfg=dcfg)
        tcfg = port_config(cfg)
        tmodel = TDebiasCLIP(port_model(np_params, tcfg, mode),
                             torch.from_numpy(tokens.copy()), port_config(dcfg))
        real = Adversary.from_cfg

        def jax_numbers(acfg, generator=None):
            adv = real(acfg, generator)
            adv.load_state_dict(adversary_params_from_jax(
                jax.tree.map(np.asarray, JAdversary.from_cfg(acfg).params)))
            return adv

        monkeypatch.setattr(Adversary, "from_cfg", staticmethod(jax_numbers))
        tc = TrainConfig(batch_size=8, num_epochs=1, eval_every_steps=1)
        kw = {"tokenizer": loop_tok, "attribute": "gender", "data_path": loop_fairface,
              "eval_n_samples": None, "sensitive_prompts": LOOP_PROMPTS, "progress": False}
        want = jrun(model=jmodel, checkpoint_dir=str(tmp_path / "j"), train_cfg=tc, **kw)
        got = trun(model=tmodel, checkpoint_dir=str(tmp_path / "t"),
                   train_cfg=port_config(tc), device="cpu", **kw)
        assert got["steps"] == want["steps"] == 2

        def losses(res):
            log = os.path.join(res["checkpoint_dir"], "logs", "metrics.jsonl")
            return [[r[k] for k in ("loss", "adv_loss", "contrastive_loss")]
                    for r in map(json.loads, open(log)) if "loss" in r]

        lj, lt = losses(want), losses(got)
        assert len(lt) == len(lj) == 2
        _close(np.asarray(lt), np.asarray(lj))
        exported = [torch.load(r["export"], map_location="cpu", weights_only=True).numpy()
                    for r in (got, want)]
        _close(exported[0], exported[1])
        assert np.abs(exported[0] - tokens).max() > 1e-4  # the tokens moved
        assert got["best_ndkl"] == pytest.approx(want["best_ndkl"], abs=1e-5)


class TestImageVitFileUnderFitArch:
    def test_loads_and_embeds_as_jax(self, tmp_path, monkeypatch, videos):
        """JAX's loader sends an OpenAI-named image-ViT file under a FiT arch
        to ``from_openai_state_dict`` and runs it as a joint video tower
        (bare proj, no conv bias, zero temporal embedding); the port loads
        it too, and both embed the same videos within 1e-5."""
        from debias_vision_lang_tpu.models import loader as jloader
        from debias_vision_lang_tpu.models.clip import init_clip_params
        from debias_vision_lang_tpu.models.convert import to_openai_state_dict

        vit = dataclasses.replace(CFG, vision=dataclasses.replace(
            CFG.vision, kind="vit", video_attention=None))
        sd = to_openai_state_dict(init_clip_params(jax.random.key(4), vit), vit)
        path = str(tmp_path / "vit.pt")
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
        monkeypatch.setattr(jloader, "resolve_arch", lambda name: CFG)
        monkeypatch.setattr(tloader, "resolve_arch", lambda name: TCFG)
        name = "m-bain/frozen-in-time/base"
        jm = jloader.model_loader(name, weights=path)[0]
        tm = tloader.model_loader(name, device="cpu", weights=path)[0]
        assert isinstance(tm, tfit.FrozenInTime)
        assert tm.attention == jm.attention == "joint"
        assert torch.equal(tm.visual.temporal_embedding, torch.zeros(T_FRAMES, 32))
        with torch.no_grad():
            got = tm.encode_image(torch.from_numpy(videos))
            four = tm.encode_image(torch.from_numpy(videos[:, 0]))
        _close(got, jm.encode_image(jnp.asarray(videos)))
        _close(four, jm.encode_image(jnp.asarray(videos[:, 0])))


class TestEngineLabel:
    @pytest.mark.parametrize("dtype,label", [(None, "auto"), ("auto", "auto"),
                                             ("float32", "float32")])
    def test_precision_label_is_jax_s(self, pair, dtype, label):
        """JAX's engine records "auto" when ``compute_dtype`` is None (and
        for "auto"); ``compute_dtype`` stays the rung that runs (float32 by
        default on the CPU; "auto" on a video tower: int8, bfloat16
        activations)."""
        from debias_vision_lang_tpu.serve.engine import InferenceEngine as JEngine
        from debias_vision_lang_torch.serve.engine import InferenceEngine

        jp, np_params, _ = pair
        te = InferenceEngine(port_model(np_params), None, max_batch=2,
                             compute_dtype=dtype, device="cpu")
        je = JEngine(jfit.FrozenInTime(params=jp, cfg=CFG), None, max_batch=2,
                     compute_dtype=dtype)
        assert te.info()["precision"] == je.info()["precision"] == label
        assert te.info()["compute_dtype"] == str(je.info()["compute_dtype"])
