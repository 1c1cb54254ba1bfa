"""The PyTorch port imports torch and never jax: a fresh interpreter runs a
tiny CPU forward through the port (bf16 and, through QuantizedCLIP, int8)
and must end with no jax module loaded.
Also the port's surface and its stdlib byte tokenizer."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "debias_vision_lang_torch"

_SCRIPT = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import debias_vision_lang_torch as dvl
from debias_vision_lang_tpu.core.config import CLIPConfig, TextConfig, VisionConfig, DebiasConfig
from debias_vision_lang_torch.models.clip import CLIP, init_clip_params
from debias_vision_lang_torch.models.debias import DebiasCLIP
from debias_vision_lang_torch.text import ByteTokenizer
from debias_vision_lang_torch.vision.preprocess import patchify_u8
cfg = CLIPConfig(name="tiny",
    vision=VisionConfig(kind="vit", image_size=32, patch_size=8, width=64, layers=1,
                        heads=1, embed_dim=16),
    text=TextConfig(vocab_size=49408, context_length=77, width=64, layers=1, heads=1,
                    embed_dim=16))
clip = CLIP(cfg)
clip.load_state_dict(init_clip_params(cfg))
model = DebiasCLIP(clip, torch.zeros(2, 64), DebiasConfig(hidden_dim=64))
u8 = np.random.default_rng(0).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
with torch.no_grad():
    img = model.encode_image(torch.from_numpy(patchify_u8(u8, 8))).float()
    prompts = dvl.gen_prompts()[:5]
    txt = model.encode_text(torch.from_numpy(ByteTokenizer()(prompts)))
    txt = txt / txt.norm(dim=-1, keepdim=True)
res = dvl.eval_ranking(np.array([0, 1, 0, 1]), img, txt, "ndkl")
assert img.shape == (4, 16) and all(np.isfinite(list(res.values())))
from debias_vision_lang_torch.ops.quant import QuantizedCLIP
qmodel = QuantizedCLIP(model, quantize_text=True)
with torch.no_grad():
    img8 = qmodel.encode_image(torch.from_numpy(patchify_u8(u8, 8))).float()
    txt8 = qmodel.encode_text(torch.from_numpy(ByteTokenizer()(prompts))).float()
assert img8.shape == (4, 16) and txt8.shape == (5, 16)
assert bool(torch.isfinite(img8).all()) and bool(torch.isfinite(txt8).all())
print("jax" in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))[:3])
"""


def test_port_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[0] == "False", proc.stdout


def test_no_jax_import_in_sources():
    rx = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)
    offenders = [str(p.relative_to(REPO)) for p in PORT.rglob("*.py")
                 if rx.search(p.read_text())]
    assert offenders == []


def test_kernel_sources_ship():
    assert (PORT / "csrc" / "fused_block.cu").exists()
    assert (PORT / "csrc" / "fused_block_q.cu").exists()
    assert (PORT / "csrc" / "common.cuh").exists()


@pytest.mark.parametrize("name", ["measure_bias", "eval_ranking", "gen_prompts",
                                  "DebiasCLIP", "model_loader", "ClipLike"])
def test_lazy_surface(name):
    import debias_vision_lang_torch as dvl

    assert getattr(dvl, name) is not None
    assert name in dir(dvl)


class TestByteTokenizer:
    def test_layout(self):
        from debias_vision_lang_torch.text import EOT_ID, SOT_ID, ByteTokenizer

        ids = ByteTokenizer()(["ab", "a good person"])
        assert ids.shape == (2, 77)
        assert list(ids[0, :4]) == [SOT_ID, ord("a"), ord("b"), EOT_ID]
        assert (ids[0, 4:] == 0).all()
        assert list(ids.argmax(-1)) == [3, 14]  # EOT is the largest id

    def test_overlong(self):
        from debias_vision_lang_torch.text import EOT_ID, ByteTokenizer

        with pytest.raises(RuntimeError, match="too long"):
            ByteTokenizer(context_length=8)(["a long sentence"])
        ids = ByteTokenizer(context_length=8)(["a long sentence"], truncate=True)
        assert ids[0, -1] == EOT_ID

    def test_all_319_prompts_fit(self):
        from debias_vision_lang_torch.eval.measure import gen_prompts
        from debias_vision_lang_torch.text import ByteTokenizer

        ids = ByteTokenizer()(gen_prompts())
        assert ids.shape == (319, 77)
        assert np.unique(ids, axis=0).shape[0] == 319
