"""The PyTorch port imports torch and never jax, nor anything of the JAX
package: a fresh interpreter runs, on the CPU, the bf16 ``measure_bias`` of a
tiny model on a synthetic FairFace layout (a cache miss, then a hit), the
efficacy world and one pretraining step, a forward through the port (bf16
and, through QuantizedCLIP, int8) and one adversarial trainer step (bf16
training through the differentiable fused blocks), and must end with no
``jax*``, no ``optax`` and no ``debias_vision_lang_tpu*`` module loaded.
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
import os, sys, tempfile
import numpy as np
import pandas as pd
import torch
from PIL import Image
torch.set_num_threads(1)
import debias_vision_lang_torch as dvl
from debias_vision_lang_torch.core.config import (CLIPConfig, TextConfig, VisionConfig,
                                                  DebiasConfig, TrainConfig)
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
root = tempfile.mkdtemp()
os.makedirs(os.path.join(root, "imgs", "train_val", "s"))
os.makedirs(os.path.join(root, "labels", "val"))
rows = []
for i in range(8):
    f = f"s/{i}.jpg"
    Image.fromarray(u8[i % 4]).save(os.path.join(root, "imgs", "train_val", f))
    rows.append({"file": f, "age": "20-29", "gender": "Male" if i % 2 else "Female",
                 "race": "White"})
pd.DataFrame(rows).to_csv(os.path.join(root, "labels", "val", "val_labels.csv"), index=False)
from debias_vision_lang_torch.vision.preprocess import Preprocess
opts = {"data_path": root, "dtype": "bfloat16", "batch_size": 4, "num_workers": 1,
        "prompts": prompts, "cache_embeddings": os.path.join(root, "embs.npz")}
res = dvl.measure_bias(model, Preprocess(32), ByteTokenizer(), "gender", opts=opts)
assert all(np.isfinite(v) for m in res.values() for v in m.values()), res
assert dvl.measure_bias(model, Preprocess(32), ByteTokenizer(), "gender", opts=opts) == res
from debias_vision_lang_torch.train import efficacy
world = efficacy.build_world(os.path.join(root, "world"), n_train=4, n_val=2)
efficacy.pretrain_tiny_clip(world["train_images"], world["train_captions"], steps=1,
                            batch_size=4, device="cpu")
adv = dvl.Adversary.from_cfg({"ADV_N_INPUT": 5, "ADV_HIDDEN_SIZE": 8, "SEED": 0})
trainer = dvl.AdversarialTrainer.create(
    model, adv, TrainConfig(train_dtype="bfloat16", embed_dtype="bfloat16"),
    ByteTokenizer()(prompts))
before = model.debias_tokens.detach().clone()
imgs = np.random.default_rng(1).normal(size=(4, 32, 32, 3)).astype(np.float32)
m = trainer.step(imgs, np.array([0, 1, 0, 1]), imgs[::-1].copy(),
                 ByteTokenizer()(["a", "b", "c", "d"]))
assert np.isfinite(m["loss"]) and not torch.equal(before, model.debias_tokens.detach())
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "debias_vision_lang_tpu"))[:5])
"""


def test_port_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout


def test_no_jax_import_in_sources():
    rx = re.compile(r"^\s*(import\s+(jax|debias_vision_lang_tpu)\b"
                    r"|from\s+(jax|debias_vision_lang_tpu)[\s.])", re.M)
    offenders = [str(p.relative_to(REPO))
                 for p in [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]
                 if rx.search(p.read_text())]
    assert offenders == []


def test_kernel_sources_ship():
    assert (PORT / "csrc" / "fused_block.cu").exists()
    assert (PORT / "csrc" / "fused_block_q.cu").exists()
    assert (PORT / "csrc" / "attention.cu").exists()
    assert (PORT / "csrc" / "common.cuh").exists()
    assert (PORT / "csrc" / "hopper.cuh").exists()
    assert (PORT / "csrc" / "attention_wgmma.cuh").exists()


def _jax_exports():
    """Every name the JAX package exports, read from its ``__init__.py`` as
    text (its eager ``from .core import`` names and its ``_LAZY`` keys)."""
    import ast

    tree = ast.parse((REPO / "debias_vision_lang_tpu" / "__init__.py").read_text())
    names = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            names += [a.asname or a.name for a in node.names]
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [t.id for t in node.targets] == ["_LAZY"]):
            names += [k.value for k in node.value.keys]
    return names


JAX_EXPORTS = _jax_exports()


def test_jax_exports_read():
    assert len(JAX_EXPORTS) == 30 and {"tokenize", "FairFace", "VALID_MODELS",
                                       "resolve_arch", "measure_bias"} <= set(JAX_EXPORTS)


@pytest.mark.parametrize("name", sorted(set(JAX_EXPORTS) | {"AdversarialTrainer",
                                                            "run_training"}))
def test_lazy_surface(name):
    import debias_vision_lang_torch as dvl

    assert getattr(dvl, name) is not None
    assert name in dir(dvl)


def test_surface_loads_no_heavy_module():
    """The eager surface is the port's ``core``: importing the package loads
    neither its datasets (pandas) nor its tokenizer, towers or kernels."""
    code = ("import sys, debias_vision_lang_torch as d; d.VALID_MODELS; "
            "print(sorted(m for m in sys.modules if m.startswith('debias_vision_lang_torch.')"
            " and not m.startswith('debias_vision_lang_torch.core')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"


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
