"""The ModifiedResNet tower family (OpenAI CLIP RN50 / RN101 / RN50x4) in
the PyTorch port against the JAX package, on the CPU at a tiny size: 64 px,
stem width 16, stages (1, 1, 1, 1) and (2, 1, 2, 1), 8 pool heads, a
1-layer text tower.

The same weights go through both packages: the port's seeded init in the
JAX tree, with every BatchNorm's scale, bias, mean and var redrawn (the
init zeroes each bottleneck's bn3 scale, which would leave every residual
branch dead and the convolutions checked against nothing).  The redrawn
bn3 scales stay in [0.2, 0.5] and the others in [0.5, 1], so activations
keep their size through the stages, as a trained tower's do.

Bars: the parameter names and shapes of every registry ResNet equal the
JAX init's; the weight bridges exact; the float32 tower within 1e-5 x
max(1, max |JAX|); the bf16 tower at per-row cosine >= 0.9999 against
JAX's bf16 and >= 0.999 against float32; OpenAI-named checkpoints through
the loader's dispatch within 1e-5; ``measure_bias`` float32 metrics within
1e-5 of JAX's; the freezing policy equal to JAX's.
"""

import gzip
import warnings

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
from debias_vision_lang_tpu.models import resnet as jres
from debias_vision_lang_torch.core.registry import CLIP_ARCHS, resolve_arch
from debias_vision_lang_torch.models import clip as tclip
from debias_vision_lang_torch.models import convert as tconvert
from debias_vision_lang_torch.models import loader as tloader
from debias_vision_lang_torch.models import resnet as tres
from debias_vision_lang_torch.models.convert import params_from_jax, to_jax_tree
from debias_vision_lang_torch.models.debias import DebiasCLIP as TDebiasCLIP
from torch_port_config import port_config

torch.set_num_threads(1)

TEXT = TextConfig(vocab_size=128, context_length=16, width=32, layers=1, heads=2,
                  embed_dim=32)
CFGS = {stages: CLIPConfig(name=f"rn-tiny-{stages}", vision=VisionConfig(
    kind="resnet", image_size=64, patch_size=32, width=16, layers=stages, heads=8,
    embed_dim=32),
    text=TEXT) for stages in ((1, 1, 1, 1), (2, 1, 2, 1))}
STAGES = list(CFGS)
RN_ARCHS = [a for a, c in CLIP_ARCHS.items() if c.vision.kind == "resnet"]


def redraw_bn(tree, rng, branch_end=False):
    """Every BatchNorm of a JAX ResNet tree redrawn: scale in [0.5, 1]
    ([0.2, 0.5] for a bottleneck's bn3, the end of its residual branch),
    bias and mean N(0, 0.1^2), var in [0.5, 2]."""
    if isinstance(tree, list):
        return [redraw_bn(t, rng) for t in tree]
    if not isinstance(tree, dict):
        return tree
    if set(tree) == {"scale", "bias", "mean", "var"}:
        n = tree["scale"].shape[0]
        lo, hi = (0.2, 0.5) if branch_end else (0.5, 1.0)
        return {"scale": rng.uniform(lo, hi, n).astype(np.float32),
                "bias": rng.normal(0, 0.1, n).astype(np.float32),
                "mean": rng.normal(0, 0.1, n).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
    block = "conv2" in tree and "attnpool" not in tree
    return {k: redraw_bn(v, rng, branch_end=block and k == "bn3") for k, v in tree.items()}


def make_pair(cfg, seed=0):
    """(JAX params, numpy tree, port CLIP) with the same weights: BatchNorms
    redrawn, the pool's biases and the text tower perturbed."""
    rng = np.random.default_rng(seed)
    tcfg = port_config(cfg)
    tree = to_jax_tree(tclip.init_clip_params(tcfg, torch.Generator().manual_seed(seed)))
    tree["visual"] = redraw_bn(tree["visual"], rng)
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        b = tree["visual"]["attnpool"][name]["bias"]
        tree["visual"]["attnpool"][name]["bias"] = (
            0.05 * rng.normal(size=b.shape)).astype(np.float32)
    tree["text"] = jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32), tree["text"])
    model = tclip.CLIP(tcfg)
    model.load_state_dict(params_from_jax(tree, tcfg))
    return jax.tree.map(jnp.asarray, tree), tree, model


@pytest.fixture(scope="module")
def pairs():
    return {stages: make_pair(cfg) for stages, cfg in CFGS.items()}


def _np(t):
    return t.detach().float().numpy()


def _cos_rows(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _images(seed, b=3, px=64):
    return np.random.default_rng(seed).normal(size=(b, px, px, 3)).astype(np.float32)


def _shapes(flat):
    return {k: tuple(v.shape) for k, v in flat.items()}


# ---------------------------------------------------------------------------
# Parameter tree and weight bridges
# ---------------------------------------------------------------------------


class TestTree:
    @pytest.mark.parametrize("arch", RN_ARCHS)
    def test_registry_archs_have_the_jax_names_and_shapes(self, arch):
        from debias_vision_lang_tpu.core.registry import resolve_arch as jresolve

        ref = jax.eval_shape(lambda: jclip.init_clip_params(jax.random.key(0),
                                                            jresolve(arch)))
        flat, want = {}, {}
        tconvert._flatten(ref, "", flat)
        for name, leaf in flat.items():  # stacked resblocks: one entry per layer
            tower, sep, rest = name.partition(".resblocks.")
            for i in range(leaf.shape[0]) if sep else [None]:
                want[f"{tower}.resblocks.{i}.{rest}" if sep else name] = (
                    tuple(leaf.shape[1:]) if sep else tuple(leaf.shape))
        got = tclip.init_clip_params(resolve_arch(arch))
        assert _shapes(got) == want
        bn3 = [v for k, v in got.items() if k.endswith(".bn3.scale") and ".layer" in k]
        assert bn3 and all(float(v.abs().max()) == 0 for v in bn3)  # CLIP's zero-init

    @pytest.mark.parametrize("stages", STAGES)
    def test_tiny_tree_structure_matches_jax(self, pairs, stages):
        _, tree, _ = pairs[stages]
        ref = jax.eval_shape(lambda: jclip.init_clip_params(jax.random.key(0),
                                                            CFGS[stages]))
        assert jax.tree.structure(ref) == jax.tree.structure(tree)
        assert isinstance(tree["visual"]["layer1"], list)
        assert len(tree["visual"]["layer3"]) == stages[2]

    @pytest.mark.parametrize("stages", STAGES)
    def test_params_from_jax_and_back_bit_exact(self, pairs, stages):
        _, tree, model = pairs[stages]
        back = to_jax_tree(model.state_dict())
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        assert all(jax.tree.leaves(jax.tree.map(np.array_equal, back, tree)))
        np.testing.assert_array_equal(_np(model.visual.layer1[0].bn3.var),
                                      tree["visual"]["layer1"][0]["bn3"]["var"])
        np.testing.assert_array_equal(
            _np(model.visual.layer2[0].downsample.conv.kernel),
            tree["visual"]["layer2"][0]["downsample"]["conv"]["kernel"])

    def test_state_dict_names_follow_the_jax_tree(self, pairs):
        _, _, model = pairs[STAGES[0]]
        names = set(model.state_dict())
        for name in ("visual.conv1.kernel", "visual.bn1.scale", "visual.bn1.var",
                     "visual.layer1.0.conv1.kernel", "visual.layer2.0.downsample.conv.kernel",
                     "visual.layer2.0.downsample.bn.mean",
                     "visual.attnpool.positional_embedding", "visual.attnpool.q_proj.kernel",
                     "visual.attnpool.c_proj.bias"):
            assert name in names
        assert model.visual.attnpool.c_proj.kernel.shape == (16 * 32, 32)


def openai_state_dict(tree):
    """A JAX ResNet CLIP tree in OpenAI CLIP naming, built by hand (as
    tests/test_convert.py builds the visual part): conv weights OIHW,
    BatchNorm weight / bias / running_mean / running_var (with the
    num_batches_tracked a torch BatchNorm2d carries), Linears [out, in]."""
    sd = {}
    v, t = tree["visual"], tree["text"]

    def put_conv(key, p):
        sd[key] = np.asarray(p["kernel"]).transpose(3, 2, 0, 1)

    def put_bn(prefix, p):
        for ours, theirs in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                             ("var", "running_var")):
            sd[f"{prefix}.{theirs}"] = np.asarray(p[ours])
        sd[f"{prefix}.num_batches_tracked"] = np.asarray(7)

    for i in (1, 2, 3):
        put_conv(f"visual.conv{i}.weight", v[f"conv{i}"])
        put_bn(f"visual.bn{i}", v[f"bn{i}"])
    for stage in range(1, 5):
        for b, block in enumerate(v[f"layer{stage}"]):
            pre = f"visual.layer{stage}.{b}"
            for i in (1, 2, 3):
                put_conv(f"{pre}.conv{i}.weight", block[f"conv{i}"])
                put_bn(f"{pre}.bn{i}", block[f"bn{i}"])
            if "downsample" in block:
                put_conv(f"{pre}.downsample.0.weight", block["downsample"]["conv"])
                put_bn(f"{pre}.downsample.1", block["downsample"]["bn"])
    ap = v["attnpool"]
    sd["visual.attnpool.positional_embedding"] = np.asarray(ap["positional_embedding"])
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        sd[f"visual.attnpool.{name}.weight"] = np.asarray(ap[name]["kernel"]).T
        sd[f"visual.attnpool.{name}.bias"] = np.asarray(ap[name]["bias"])
    sd["token_embedding.weight"] = np.asarray(t["token_embedding"])
    sd["positional_embedding"] = np.asarray(t["positional_embedding"])
    sd["ln_final.weight"] = np.asarray(t["ln_final"]["scale"])
    sd["ln_final.bias"] = np.asarray(t["ln_final"]["bias"])
    sd["text_projection"] = np.asarray(t["text_projection"])
    sd["logit_scale"] = np.asarray(tree["logit_scale"])
    rb = t["resblocks"]
    for i in range(rb["ln_1"]["scale"].shape[0]):
        pre = f"transformer.resblocks.{i}"
        for ln in ("ln_1", "ln_2"):
            sd[f"{pre}.{ln}.weight"] = np.asarray(rb[ln]["scale"][i])
            sd[f"{pre}.{ln}.bias"] = np.asarray(rb[ln]["bias"][i])
        for ours, theirs in (("attn.wqkv", "attn.in_proj_weight"),
                             ("attn.wo", "attn.out_proj.weight"),
                             ("mlp.w1", "mlp.c_fc.weight"), ("mlp.w2", "mlp.c_proj.weight")):
            group, leaf = ours.split(".")
            sd[f"{pre}.{theirs}"] = np.asarray(rb[group][leaf][i]).T
        for ours, theirs in (("attn.bqkv", "attn.in_proj_bias"), ("attn.bo", "attn.out_proj.bias"),
                             ("mlp.b1", "mlp.c_fc.bias"), ("mlp.b2", "mlp.c_proj.bias")):
            group, leaf = ours.split(".")
            sd[f"{pre}.{theirs}"] = np.asarray(rb[group][leaf][i])
    return sd


class TestOpenAICheckpoint:
    @pytest.mark.parametrize("stages", STAGES)
    def test_converter_equals_jax_converter(self, pairs, stages):
        from debias_vision_lang_tpu.models.convert import from_openai_state_dict

        _, tree, model = pairs[stages]
        sd = openai_state_dict(tree)
        got = tconvert.params_from_openai_state_dict(sd)
        assert _shapes(got) == _shapes(model.state_dict())
        want = jax.tree.map(np.asarray, from_openai_state_dict(sd))
        back = to_jax_tree(got)
        assert jax.tree.structure(back) == jax.tree.structure(want)
        assert all(jax.tree.leaves(jax.tree.map(np.array_equal, back, want)))

    @pytest.mark.parametrize("stages", STAGES)
    def test_pt_through_the_loader_dispatch(self, pairs, stages, tmp_path):
        _, tree, model = pairs[stages]
        path = tmp_path / "rn.pt"
        torch.save({f"module.{k}": torch.from_numpy(np.ascontiguousarray(a))
                    for k, a in openai_state_dict(tree).items()}, path)
        params = tloader._load_weights_file(str(path), port_config(CFGS[stages]))
        loaded = tclip.CLIP(port_config(CFGS[stages]))
        loaded.load_state_dict(params)
        x = torch.from_numpy(_images(3))
        with torch.no_grad():
            want, got = model.encode_image(x), loaded.encode_image(x)
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)

    def test_dispatch_tells_the_kinds_apart(self, pairs):
        _, tree, _ = pairs[STAGES[0]]
        rn = tloader._dispatch_state_dict(openai_state_dict(tree))
        assert tloader.tower_kind(rn) == "resnet"
        vit = tclip.init_clip_params(tclip.CLIPConfig(
            name="v", vision=tclip.VisionConfig(kind="vit", image_size=32, patch_size=8,
                                                width=64, layers=1, heads=1, embed_dim=32),
            text=port_config(TEXT)))
        slip = {k: v for k, v in vit.items() if "ln_pre" not in k}
        assert tloader.tower_kind(vit) == "vit"
        assert tloader.tower_kind(slip) == "slip_vit"

    @pytest.mark.parametrize("arch", ["openai/CLIP/ViT-B/16",
                                      "facebookresearch/SLIP/ViT-B/16"])
    def test_dispatch_refuses_a_resnet_for_a_vit_arch(self, pairs, arch):
        _, tree, _ = pairs[STAGES[0]]
        with pytest.raises(ValueError, match="'resnet' image tower"):
            tloader._dispatch_state_dict(openai_state_dict(tree), resolve_arch(arch))


# ---------------------------------------------------------------------------
# The towers
# ---------------------------------------------------------------------------


class TestTowers:
    @pytest.mark.parametrize("stages", STAGES)
    def test_float32_matches_jax(self, pairs, stages):
        jp, _, model = pairs[stages]
        x = _images(1)
        want = np.asarray(jres.encode_image_resnet(jp["visual"], jnp.asarray(x),
                                                   CFGS[stages].vision))
        with torch.no_grad():
            got = _np(tres.encode_image_resnet(model.visual, torch.from_numpy(x)))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(want).max())))

    @pytest.mark.parametrize("stages", STAGES)
    def test_bfloat16_matches_jax_and_float32(self, pairs, stages):
        jp, _, model = pairs[stages]
        x = _images(2)
        want = np.asarray(jres.encode_image_resnet(
            jp["visual"], jnp.asarray(x), CFGS[stages].vision,
            dtype=jnp.bfloat16).astype(jnp.float32))
        with torch.no_grad():
            got = model.encode_image(torch.from_numpy(x), dtype=torch.bfloat16)
            ref32 = model.encode_image(torch.from_numpy(x))
        assert got.dtype == torch.bfloat16
        assert _cos_rows(_np(got), want).min() >= 0.9999
        assert _cos_rows(_np(got), _np(ref32)).min() >= 0.999

    def test_kernel_knobs_are_accepted_and_ignored(self, pairs):
        _, _, model = pairs[STAGES[1]]
        x = torch.from_numpy(_images(4, b=2))
        with torch.no_grad():
            want = model.encode_image(x)
            got = model.encode_image(x, fused=True, use_pallas=True, remat=True)
        assert torch.equal(got, want)

    def test_average_pool_is_the_jax_reduce_window(self):
        x = np.random.default_rng(5).normal(size=(2, 8, 8, 16)).astype(np.float32) * 10
        for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
            want = np.asarray(jres.avg_pool(jnp.asarray(x).astype(jdt), 2).astype(jnp.float32))
            got = _np(tres.avg_pool(torch.from_numpy(x).to(tdt), 2))
            np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("shape", [(2, 64, 64), (2, 49, 3072), (64, 64, 3)])
    def test_non_nhwc_input_raises(self, pairs, shape):
        _, _, model = pairs[STAGES[0]]
        with pytest.raises(ValueError, match="NHWC"):
            model.encode_image(torch.zeros(shape))


class TestTf32Scope:
    def _spy_conv(self, monkeypatch):
        seen = []
        orig = tres.F.conv2d

        def spy(*a, **k):
            seen.append(torch.backends.cudnn.allow_tf32)
            return orig(*a, **k)

        monkeypatch.setattr(tres.F, "conv2d", spy)
        return seen

    def test_float32_convs_run_with_tf32_off_and_restore(self, pairs, monkeypatch):
        _, _, model = pairs[STAGES[0]]
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
        seen = self._spy_conv(monkeypatch)
        with torch.no_grad():
            model.encode_image(torch.from_numpy(_images(6, b=1)))
        assert seen and not any(seen)
        assert torch.backends.cudnn.allow_tf32 is True

    def test_bfloat16_convs_leave_the_flag(self, pairs, monkeypatch):
        _, _, model = pairs[STAGES[0]]
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
        seen = self._spy_conv(monkeypatch)
        with torch.no_grad():
            model.encode_image(torch.from_numpy(_images(6, b=1)), dtype=torch.bfloat16)
        assert seen and all(seen)

    def test_scope_restores_after_an_error(self, monkeypatch):
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
        with pytest.raises(KeyError):
            with tres.tf32_off():
                assert torch.backends.cudnn.allow_tf32 is False
                raise KeyError("boom")
        assert torch.backends.cudnn.allow_tf32 is True

    def test_kernel_copies_follow_the_parameter_version(self, pairs):
        _, _, model = pairs[STAGES[0]]
        conv = model.visual.conv1
        saved = conv.kernel.detach().clone()
        try:
            with torch.no_grad():
                first = tres._oihw(conv.kernel, torch.float32)
                assert tres._oihw(conv.kernel, torch.float32) is first
                assert first.is_contiguous(memory_format=torch.channels_last)
                assert first.shape == (8, 3, 3, 3)
                conv.kernel.mul_(2.0)
                again = tres._oihw(conv.kernel, torch.float32)
                torch.testing.assert_close(again, 2 * first, rtol=0, atol=0)
        finally:
            with torch.no_grad():
                conv.kernel.copy_(saved)
        # a kernel that takes a gradient is never served from the copies
        assert tres._oihw(conv.kernel, torch.float32).requires_grad


# ---------------------------------------------------------------------------
# The entry points
# ---------------------------------------------------------------------------


class TestEntryPoints:
    @pytest.mark.parametrize("arch", RN_ARCHS)
    def test_from_cfg_builds_every_registry_resnet(self, arch):
        model, preprocess, _, alias = TDebiasCLIP.from_cfg(
            {"CLIP_ARCH": f"openai/CLIP/{arch}", "PRETRAINED": False, "SEED": 1},
            device="cpu")
        cfg = CLIP_ARCHS[arch]
        assert isinstance(model.clip.visual, tres.ModifiedResNet)
        assert alias == f"oai-clip-{arch.lower()}"
        assert preprocess.n_px == cfg.vision.image_size
        assert model.debias_tokens.shape == (2, cfg.text.width)
        assert len(model.clip.visual.layer3) == cfg.vision.layers[2]

    def test_model_loader_forward_at_full_width(self):
        model, preprocess, _, alias = tloader.model_loader(
            "openai/CLIP/RN50", device="cpu", pretrained=False)
        x = torch.from_numpy(_images(7, b=1, px=224))
        with torch.no_grad():
            out = model.encode_image(x)
        assert alias == "oai-clip-rn50" and out.shape == (1, 1024)
        assert torch.isfinite(out).all()

    def test_cli_measure_bias_builds_rn50(self, monkeypatch, tmp_path):
        from debias_vision_lang_torch import cli
        from debias_vision_lang_torch.eval import measure

        vocab = tmp_path / "bpe_vocab.txt.gz"
        with gzip.open(vocab, "wt", encoding="utf-8") as f:
            f.write("#version: 0.2\nt h\nth e</w>\na </w>\n")
        from debias_vision_lang_torch.text import tokenizer as ttok

        monkeypatch.setattr(ttok, "BPE_VOCAB_PATH", vocab)
        seen = []
        monkeypatch.setattr(measure, "measure_bias",
                            lambda *a, **k: seen.append(a) or {"ndkl": {"eq_opp": 0.0}})
        cli.main(["measure-bias", "--device", "cpu", "--random-weights", "--model",
                  "openai/CLIP/RN50", "--dtype", "int8"])
        (model, preprocess, tokenizer), = seen
        assert isinstance(model.visual, tres.ModifiedResNet) and tokenizer is not None
        assert preprocess.n_px == 224

    def test_trainer_int8_embed_stays_vit_only(self, pairs):
        from debias_vision_lang_torch.core.config import TrainConfig
        from debias_vision_lang_torch.models.adversary import Adversary
        from debias_vision_lang_torch.train.adversarial import AdversarialTrainer

        _, _, model = pairs[STAGES[0]]
        tm = TDebiasCLIP(model, torch.zeros(2, 32), port_config(DebiasConfig(hidden_dim=32)))
        adv = Adversary.from_cfg({"ADV_N_INPUT": 3, "ADV_HIDDEN_SIZE": 8, "SEED": 0})
        with pytest.raises(NotImplementedError, match="ViT towers only"):
            AdversarialTrainer.create(tm, adv, TrainConfig(embed_dtype="int8"),
                                      np.ones((3, 16), np.int64))


class TestFreezing:
    @pytest.fixture
    def both(self, pairs):
        jp, tree, model = pairs[STAGES[1]]
        return tree, model

    def test_layer_counts_equal_jax(self, both):
        from debias_vision_lang_tpu.models.debias import layer_counts as jcounts
        from debias_vision_lang_torch.models.debias import layer_counts

        tree, model = both
        assert layer_counts(model) == jcounts(tree) == {"image": 0, "text": 1}

    def test_classify_params_equal_jax(self, both):
        from debias_vision_lang_tpu.models.debias import classify_params as jclassify
        from debias_vision_lang_torch.models.debias import classify_params

        tree, model = both
        jmeta, jclassed = jclassify(tree)
        meta, classed = classify_params(model)
        assert meta == jmeta
        jtypes = {c["name"].replace("/", "."): c["type"] for c in jclassed}
        types = {c["name"]: c["type"] for c in classed}
        visual = {k: v for k, v in types.items() if k.startswith("visual.")}
        assert visual and set(visual.values()) == {"other"}
        assert all(jtypes[k] == v for k, v in visual.items())

    @pytest.mark.parametrize("n_text", [0, 1])
    @pytest.mark.parametrize("freeze_proj", [True, False])
    def test_trainable_mask_equals_jax(self, both, n_text, freeze_proj):
        from debias_vision_lang_tpu.models.debias import trainable_mask as jmask
        from debias_vision_lang_torch.models.debias import trainable_mask

        tree, model = both
        dcfg = DebiasConfig(n_train_text_layers=n_text, freeze_proj=freeze_proj)
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
        assert all(v == 0.0 for k, v in got.items() if k.startswith("visual."))

    def test_trainable_mask_refuses_image_layers_as_jax(self, both):
        from debias_vision_lang_tpu.models.debias import trainable_mask as jmask
        from debias_vision_lang_torch.models.debias import trainable_mask

        tree, model = both
        dcfg = DebiasConfig(n_train_vid_layers=1)
        with pytest.raises(ValueError) as want:
            jmask(tree, dcfg)
        with pytest.raises(ValueError) as got:
            trainable_mask(model, port_config(dcfg))
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# measure_bias and serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fairface(tmp_path_factory):
    """A miniature FairFace layout of 8 validation images at 64 px."""
    root = tmp_path_factory.mktemp("fairface_rn")
    img_dir = root / "imgs" / "train_val" / "val"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(11)
    rows = []
    for i in range(8):
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(
            img_dir / f"{i}.png")
        rows.append({"file": f"val/{i}.png", "age": "20-29",
                     "gender": "Male" if i % 2 else "Female", "race": "White",
                     "service_test": True})
    for mode in ("train", "val"):
        (root / "labels" / mode).mkdir(parents=True)
        pd.DataFrame(rows).to_csv(root / "labels" / mode / f"{mode}_labels.csv",
                                  index=False)
    return str(root)


def tok(texts):
    """Deterministic toy tokenizer over a 128-token vocabulary: SOT, one
    content id, EOT (the largest id)."""
    out = np.zeros((len(texts), 16), np.int64)
    for i, t in enumerate(texts):
        out[i, :3] = [126, sum(t.encode()) % 100 + 1, 127]
    return out


@pytest.fixture(scope="module")
def debias_models(pairs):
    from debias_vision_lang_tpu.models.debias import DebiasCLIP as JDebiasCLIP

    jp, _, model = pairs[STAGES[1]]
    deb = np.random.default_rng(12).normal(size=(2, 32)).astype(np.float32)
    dcfg = DebiasConfig(num_debias_tokens=2, hidden_dim=32)
    jm = JDebiasCLIP(clip_params=jp, debias_tokens=jnp.asarray(deb),
                     clip_cfg=CFGS[STAGES[1]], debias_cfg=dcfg)
    return jm, TDebiasCLIP(model, torch.from_numpy(deb), port_config(dcfg))


OPTS = {"batch_size": 4, "num_workers": 2, "topn": 4}


def measure_both(jm, tm, fairface, dtype):
    from debias_vision_lang_tpu.eval.measure import measure_bias
    from debias_vision_lang_tpu.vision.preprocess import Preprocess
    from debias_vision_lang_torch.eval.measure import measure_bias as tmeasure_bias
    from debias_vision_lang_torch.vision.preprocess import Preprocess as TPreprocess

    opts = {**OPTS, "data_path": fairface, "dtype": dtype}
    want = measure_bias(jm, Preprocess(64), tok, "gender", opts=opts)
    got = tmeasure_bias(tm, TPreprocess(64), tok, "gender", opts=opts)
    return got, want


class TestMeasureBias:
    def test_float32_metrics_match_jax(self, fairface, debias_models):
        got, want = measure_both(*debias_models, fairface, "float32")
        assert set(got) == set(want) == {"maxskew", "ndkl"}
        for ev in want:
            for k in want[ev]:
                assert got[ev][k] == pytest.approx(want[ev][k], abs=1e-5)

    @pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int8-text"])
    def test_every_rung_runs_unstaged_and_matches_the_oracle(self, fairface, debias_models,
                                                            monkeypatch, dtype):
        from debias_vision_lang_torch.eval import measure as tmeasure
        from debias_vision_lang_torch.vision.preprocess import Preprocess as TPreprocess

        _, tm = debias_models
        staged = []
        orig = tmeasure.HostLoader.__init__

        def spy(self, *a, **k):
            staged.append(k.get("native_patch"))
            orig(self, *a, **k)

        monkeypatch.setattr(tmeasure.HostLoader, "__init__", spy)
        opts = {**OPTS, "data_path": fairface, "dtype": dtype}
        got, said = _rung_warnings(lambda: tmeasure.measure_bias(
            tm, TPreprocess(64), tok, "gender", opts=opts))
        assert any("ModifiedResNet" in m for m in said) == ("int8" in dtype)
        oracle = tmeasure.measure_bias(tm, TPreprocess(64), tok, "gender",
                                       opts={**opts, "engine": "oracle"})
        assert staged[0] is None  # NHWC batches: no patch staging for a ResNet
        for ev in got:
            for k in got[ev]:
                assert np.isfinite(got[ev][k])
                assert got[ev][k] == pytest.approx(oracle[ev][k], abs=1e-5)

    def test_auto_runs_the_bfloat16_rung(self, fairface, debias_models):
        """"auto" is JAX's bfloat16 rung for a ResNet: the bf16 call's
        metrics bit for bit, and no int8 warning."""
        from debias_vision_lang_torch.eval.measure import measure_bias
        from debias_vision_lang_torch.vision.preprocess import Preprocess as TPreprocess

        out = {}
        for dtype in ("auto", "bfloat16"):
            out[dtype], said = _rung_warnings(lambda: measure_bias(
                debias_models[1], TPreprocess(64), tok, "gender",
                opts={**OPTS, "data_path": fairface, "dtype": dtype}))
            assert not any("ModifiedResNet" in m for m in said)
        assert out["auto"] == out["bfloat16"]


def _rung_warnings(fn):
    """fn()'s result and the messages of the UserWarnings it raised."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(w.message) for w in caught if issubclass(w.category, UserWarning)]


class TestServing:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
    def test_engine_rows_are_the_direct_call(self, debias_models, dtype):
        from debias_vision_lang_torch.ops.quant import resolve_compute
        from debias_vision_lang_torch.serve.engine import InferenceEngine
        from debias_vision_lang_torch.vision.preprocess import preprocess_batch

        _, tm = debias_models
        engine, said = _rung_warnings(lambda: InferenceEngine(
            tm, tok, max_batch=4, compute_dtype=dtype, device="cpu"))
        assert any("ModifiedResNet" in m for m in said) == (dtype == "int8")
        assert engine._patch is None and engine.n_px == 64
        u8 = np.random.default_rng(14).integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
        rows = engine.embed_image_arrays(list(u8))
        model, dt = resolve_compute(engine.model, dtype)
        with torch.no_grad():
            want = model.encode_image(preprocess_batch(torch.from_numpy(u8), 64),
                                      dtype=dt).float()
        np.testing.assert_array_equal(np.asarray(rows), _np(want))
        text = engine.embed_token_arrays(list(tok(["a", "b"])))
        assert np.asarray(text).shape == (2, 32)


def test_registry_lists_three_resnets():
    assert RN_ARCHS == ["RN50", "RN101", "RN50x4"]
    text = CLIP_ARCHS["RN50x4"].text
    assert (text.width, text.heads, text.layers) == (640, 10, 12)
