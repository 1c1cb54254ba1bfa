"""Checkpoint naming in the PyTorch port against the JAX package's converters,
on the CPU: HuggingFace ``CLIPModel`` (built offline from a local
``CLIPConfig`` with random weights), facebookresearch/SLIP and the
OpenAI-named export of a SLIP tree convert to exactly the tensors JAX's
converter + ``params_from_jax`` give; the HF model's image and text features
are the port's float32 towers' within 2e-5; ``_dispatch_state_dict`` routes
by key naming; the HuggingFace lookup reads only the local cache and opens
no socket.
"""

import socket

import jax
import numpy as np
import pytest
import torch

from debias_vision_lang_tpu.core.config import CLIPConfig, TextConfig, VisionConfig
from debias_vision_lang_tpu.models import convert as jconvert
from debias_vision_lang_torch.models import clip as tclip
from debias_vision_lang_torch.models import convert as tconvert
from debias_vision_lang_torch.models import loader as tloader
from debias_vision_lang_torch.models.convert import params_from_jax
from torch_port_config import port_config

torch.set_num_threads(1)

VOCAB, CTX = 99, 16
HF_CFG = CLIPConfig(
    name="hf-tiny",
    vision=VisionConfig(kind="vit", image_size=32, patch_size=8, width=64, layers=2,
                        heads=2, embed_dim=32),
    text=TextConfig(vocab_size=VOCAB, context_length=CTX, width=64, layers=2, heads=2,
                    embed_dim=32))


def _exact(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


@pytest.fixture(scope="module")
def hf_model():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.CLIPConfig(
        text_config={"vocab_size": VOCAB, "hidden_size": 64, "intermediate_size": 256,
                     "num_hidden_layers": 2, "num_attention_heads": 2,
                     "max_position_embeddings": CTX, "hidden_act": "quick_gelu",
                     "eos_token_id": VOCAB - 1},
        vision_config={"hidden_size": 64, "intermediate_size": 256,
                       "num_hidden_layers": 2, "num_attention_heads": 2,
                       "image_size": 32, "patch_size": 8, "hidden_act": "quick_gelu"},
        projection_dim=32)
    torch.manual_seed(0)
    model = transformers.CLIPModel(hf_cfg).eval()
    with torch.no_grad():  # LayerNorms and biases away from their init
        for name, p in model.named_parameters():
            if "norm" in name or name.endswith("bias"):
                p.add_(0.05 * torch.randn(p.shape))
    return model


def _tokens():
    rng = np.random.default_rng(0)
    t = np.zeros((3, CTX), np.int64)
    t[:, 0] = VOCAB - 2
    for i, n in enumerate([4, 7, CTX - 2]):
        t[i, 1:n] = rng.integers(1, VOCAB - 2, n - 1)
        t[i, n] = VOCAB - 1
    return t


class TestHuggingFace:
    def test_state_dict_equals_jax_converter(self, hf_model):
        want = params_from_jax(jax.tree.map(np.asarray,
                                            jconvert.from_hf_model(hf_model, HF_CFG)),
                               port_config(HF_CFG))
        _exact(tconvert.from_hf_model(hf_model), want)
        _exact(tconvert.from_hf_state_dict(
            {k: v.numpy() for k, v in hf_model.state_dict().items()}), want)

    def test_features_match_hf(self, hf_model):
        model = tclip.CLIP(port_config(HF_CFG))
        model.load_state_dict(tconvert.from_hf_model(hf_model))
        imgs = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
        ids = _tokens()
        with torch.no_grad():
            ref_i = hf_model.get_image_features(
                pixel_values=torch.from_numpy(imgs.transpose(0, 3, 1, 2).copy()))
            ref_t = hf_model.get_text_features(input_ids=torch.from_numpy(ids))
            got_i = model.encode_image(torch.from_numpy(imgs))
            got_t = model.encode_text(torch.from_numpy(ids))
        np.testing.assert_allclose(got_i.numpy(), ref_i.numpy(), atol=2e-5)
        np.testing.assert_allclose(got_t.numpy(), ref_t.numpy(), atol=2e-5)

    @pytest.mark.parametrize("fmt", ["pt", "safetensors"])
    def test_weights_file_goes_through_dispatch(self, hf_model, tmp_path, fmt):
        path = str(tmp_path / f"hf.{fmt}")
        sd = {k: v.contiguous() for k, v in hf_model.state_dict().items()}
        if fmt == "pt":
            torch.save(sd, path)
        else:
            from safetensors.torch import save_file

            save_file(sd, path)
        _exact(tloader._load_weights_file(path, port_config(HF_CFG)),
               tconvert.from_hf_model(hf_model))


SLIP_W, SLIP_L, SLIP_P, SLIP_IMG, SLIP_E = 32, 2, 8, 16, 16
SLIP_CFG = CLIPConfig(
    name="slip-tiny",
    vision=VisionConfig(kind="slip_vit", image_size=SLIP_IMG, patch_size=SLIP_P,
                        width=SLIP_W, layers=SLIP_L, heads=2, embed_dim=SLIP_E),
    text=TextConfig(vocab_size=64, context_length=12, width=SLIP_W, layers=SLIP_L,
                    heads=2, embed_dim=SLIP_E))


def _slip_sd(seed=3):
    """A facebookresearch/SLIP checkpoint's state dict (``module.`` keys, a
    timm image tower, CLIP's text tower, an SSL-head tensor)."""
    W, L, P, E = SLIP_W, SLIP_L, SLIP_P, SLIP_E
    shapes = {
        "module.visual.cls_token": (1, 1, W),
        "module.visual.pos_embed": (1, (SLIP_IMG // P) ** 2 + 1, W),
        "module.visual.patch_embed.proj.weight": (W, 3, P, P),
        "module.visual.patch_embed.proj.bias": (W,),
        "module.visual.norm.weight": (W,), "module.visual.norm.bias": (W,),
        "module.image_projection": (W, E),
        "module.token_embedding.weight": (64, W),
        "module.positional_embedding": (12, W),
        "module.ln_final.weight": (W,), "module.ln_final.bias": (W,),
        "module.text_projection": (W, E), "module.logit_scale": (),
        "module.image_mlp.0.weight": (W, W),  # SSL head: ignored
    }
    for i in range(L):
        v, t = f"module.visual.blocks.{i}", f"module.transformer.resblocks.{i}"
        shapes.update({
            f"{v}.norm1.weight": (W,), f"{v}.norm1.bias": (W,),
            f"{v}.attn.qkv.weight": (3 * W, W), f"{v}.attn.qkv.bias": (3 * W,),
            f"{v}.attn.proj.weight": (W, W), f"{v}.attn.proj.bias": (W,),
            f"{v}.norm2.weight": (W,), f"{v}.norm2.bias": (W,),
            f"{v}.mlp.fc1.weight": (4 * W, W), f"{v}.mlp.fc1.bias": (4 * W,),
            f"{v}.mlp.fc2.weight": (W, 4 * W), f"{v}.mlp.fc2.bias": (W,),
            f"{t}.ln_1.weight": (W,), f"{t}.ln_1.bias": (W,),
            f"{t}.attn.in_proj_weight": (3 * W, W), f"{t}.attn.in_proj_bias": (3 * W,),
            f"{t}.attn.out_proj.weight": (W, W), f"{t}.attn.out_proj.bias": (W,),
            f"{t}.ln_2.weight": (W,), f"{t}.ln_2.bias": (W,),
            f"{t}.mlp.c_fc.weight": (4 * W, W), f"{t}.mlp.c_fc.bias": (4 * W,),
            f"{t}.mlp.c_proj.weight": (W, 4 * W), f"{t}.mlp.c_proj.bias": (W,),
        })
    rng = np.random.default_rng(seed)
    return {k: np.asarray(rng.normal(size=s) * 0.1, np.float32) for k, s in shapes.items()}


def _jax_slip(sd):
    return params_from_jax(jax.tree.map(np.asarray, jconvert.from_slip_state_dict(sd)),
                           port_config(SLIP_CFG))


class TestSlip:
    def test_raw_dict_equals_jax(self):
        sd = _slip_sd()
        got = tconvert.from_slip_state_dict(sd)
        _exact(got, _jax_slip(sd))
        assert "visual.conv1.bias" in got and not any("ln_pre" in k for k in got)
        assert not any("image_mlp" in k for k in got)

    def test_checkpoint_dict_of_torch_tensors(self):
        sd = _slip_sd(4)
        ckpt = {"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}, "epoch": 24}
        _exact(tconvert.from_slip_state_dict(ckpt), _jax_slip(sd))

    def test_loads_into_a_slip_tower(self):
        model = tclip.CLIP(port_config(SLIP_CFG))
        model.load_state_dict(tconvert.from_slip_state_dict(_slip_sd()))  # strict
        out = model.encode_image(torch.zeros(1, SLIP_IMG, SLIP_IMG, 3))
        assert out.shape == (1, SLIP_E) and bool(torch.isfinite(out).all())

    def test_openai_export_of_a_slip_tree(self):
        """``to_openai_state_dict`` of a SLIP tree (conv bias, no ln_pre)
        converts back exactly, as JAX's ``from_openai_state_dict`` does."""
        tree = jax.tree.map(np.asarray, jconvert.from_slip_state_dict(_slip_sd(5)))
        export = jconvert.to_openai_state_dict(tree, SLIP_CFG)
        assert "visual.conv1.bias" in export and "visual.ln_pre.weight" not in export
        want = params_from_jax(jax.tree.map(np.asarray,
                                            jconvert.from_openai_state_dict(export)),
                               port_config(SLIP_CFG))
        got = tconvert.params_from_openai_state_dict(export)
        _exact(got, want)
        _exact(got, params_from_jax(tree, port_config(SLIP_CFG)))

    def test_params_from_jax_carries_a_slip_tree(self):
        tree = jax.tree.map(np.asarray, jconvert.from_slip_state_dict(_slip_sd(6)))
        got = params_from_jax(tree, port_config(SLIP_CFG))
        np.testing.assert_array_equal(got["visual.conv1.bias"].numpy(),
                                      tree["visual"]["conv1"]["bias"])


class TestDispatch:
    @pytest.mark.parametrize("naming", ["slip", "hf", "openai", "openai-module"])
    def test_routes_by_key_naming(self, naming, monkeypatch):
        calls = []
        for name in ("from_slip_state_dict", "from_hf_state_dict",
                     "params_from_openai_state_dict"):
            monkeypatch.setattr(tconvert, name,
                                lambda sd, name=name: calls.append((name, sorted(sd)))
                                or {"visual.ln_pre.scale": None})
        sd = {"slip": {"module.visual.blocks.0.norm1.weight": 0, "image_projection": 0},
              "hf": {"text_model.embeddings.token_embedding.weight": 0},
              "openai": {"visual.class_embedding": 0},
              "openai-module": {"state_dict": {"module.visual.class_embedding": 0}}}[naming]
        tloader._dispatch_state_dict(sd)
        want = {"slip": "from_slip_state_dict", "hf": "from_hf_state_dict"}.get(
            naming, "params_from_openai_state_dict")
        assert [c[0] for c in calls] == [want]
        if naming == "openai-module":
            assert calls[0][1] == ["visual.class_embedding"]

    def test_video_names_go_to_the_fit_converter(self, monkeypatch):
        calls = []
        monkeypatch.setattr(tconvert, "from_fit_state_dict",
                            lambda sd: calls.append(sorted(sd))
                            or {"visual.temporal_embedding": None})
        sd = {"state_dict": {"module.video_model.cls_token": 0}}
        assert tloader._dispatch_state_dict(sd) == {"visual.temporal_embedding": None}
        assert calls == [["module.video_model.cls_token"]]

    def test_tower_kind_must_match_the_arch(self):
        sd = _slip_sd()
        assert tloader._dispatch_state_dict(sd, port_config(SLIP_CFG))
        with pytest.raises(ValueError, match="'slip_vit' image tower"):
            tloader._dispatch_state_dict(sd, port_config(HF_CFG))

    def test_slip_pt_file(self, tmp_path):
        path = str(tmp_path / "slip.pt")
        sd = _slip_sd(7)
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()},
                    "epoch": 3}, path)
        _exact(tloader._load_weights_file(path, port_config(SLIP_CFG)), _jax_slip(sd))


@pytest.fixture
def no_socket(monkeypatch):
    def refuse(*a, **k):
        pytest.fail("the HuggingFace lookup opened a socket")

    monkeypatch.setattr(socket, "create_connection", refuse)
    monkeypatch.setattr(socket.socket, "connect", refuse)
    monkeypatch.delenv("DEBIAS_VLT_WEIGHTS_DIR", raising=False)


class TestHfLookup:
    def test_failure_gives_none_without_a_socket(self, no_socket, monkeypatch):
        transformers = pytest.importorskip("transformers")
        calls = []

        def raise_(name, **kw):
            calls.append((name, kw))
            raise OSError("not in the local cache")

        monkeypatch.setattr(transformers.CLIPModel, "from_pretrained", raise_)
        assert tloader._resolve_pretrained("openai/CLIP/ViT-B/16") is None
        assert calls == [("openai/clip-vit-base-patch16", {"local_files_only": True})]

    def test_local_model_converts(self, no_socket, monkeypatch, hf_model):
        transformers = pytest.importorskip("transformers")
        monkeypatch.setattr(transformers.CLIPModel, "from_pretrained",
                            lambda name, **kw: hf_model)
        _exact(tloader._resolve_pretrained("openai/CLIP/ViT-L/14"),
               tconvert.from_hf_model(hf_model))

    def test_no_lookup_for_other_families(self, no_socket, monkeypatch):
        transformers = pytest.importorskip("transformers")
        monkeypatch.setattr(transformers.CLIPModel, "from_pretrained",
                            lambda *a, **k: pytest.fail("looked up a SLIP name"))
        assert tloader._resolve_pretrained("facebookresearch/SLIP/ViT-L/16") is None

    def test_weights_dir_first(self, no_socket, monkeypatch, tmp_path):
        sd = _slip_sd(8)
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   str(tmp_path / "fb-slip-vit-l-16.pt"))
        monkeypatch.setenv("DEBIAS_VLT_WEIGHTS_DIR", str(tmp_path))
        _exact(tloader._resolve_pretrained("facebookresearch/SLIP/ViT-L/16"), _jax_slip(sd))
