"""Zero-shot classification in the PyTorch port (``eval/zero_shot.py`` and the
CLI's ``zero-shot``) against the JAX package's, on the CPU at a tiny size:
the same JAX-initialised weights (OpenAI and SLIP towers) and a 3-class
folder of images.  Bars: the classifier within 1e-5 of JAX's, ``classify``'s
top-k equal, and top-1 / top-5 / n of ``zero_shot_accuracy`` equal to JAX's
at float32; the kernels' rungs run and match a numpy recomputation from the
port's own embeddings.
"""

import gzip
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from debias_vision_lang_tpu.core.config import CLIPConfig, TextConfig, VisionConfig
from debias_vision_lang_tpu.eval import zero_shot as jzs
from debias_vision_lang_tpu.models import clip as jclip
from debias_vision_lang_torch import cli as tcli
from debias_vision_lang_torch.data.loader import HostLoader
from debias_vision_lang_torch.eval import zero_shot as tzs
from debias_vision_lang_torch.models import clip as tclip
from debias_vision_lang_torch.models.convert import params_from_jax
from debias_vision_lang_torch.vision.preprocess import preprocess_batch
from torch_port_config import port_config

torch.set_num_threads(1)

CLASSES = ["cat", "dog", "truck"]
IMAGENET_STATS = {"image_mean": (0.485, 0.456, 0.406), "image_std": (0.229, 0.224, 0.225)}


def _cfg(kind):
    stats = IMAGENET_STATS if kind == "slip_vit" else {}
    return CLIPConfig(
        name=f"zs-{kind}",
        vision=VisionConfig(kind=kind, image_size=32, patch_size=8, width=64, layers=2,
                            heads=1, embed_dim=32, **stats),
        text=TextConfig(vocab_size=512, context_length=77, width=64, layers=2, heads=1,
                        embed_dim=32))


@pytest.fixture(scope="module", params=["vit", "slip_vit"])
def models(request):
    """(JAX CLIP bundle, port CLIP, config) holding the same weights."""
    from debias_vision_lang_tpu.models.loader import CLIP as JCLIP

    cfg = _cfg(request.param)
    rng = np.random.default_rng(0)
    np_params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        jclip.init_clip_params(jax.random.key(1), cfg))
    model = tclip.CLIP(port_config(cfg))
    model.load_state_dict(params_from_jax(np_params, port_config(cfg)))
    return JCLIP(params=jax.tree.map(jnp.asarray, np_params), cfg=cfg), model, cfg


def tok(texts):
    """Deterministic toy tokenizer: SOT, three content ids, EOT (max id)."""
    out = np.zeros((len(texts), 77), np.int64)
    for i, t in enumerate(texts):
        b = t.encode()
        out[i, :5] = [510, sum(b) % 400 + 1, len(b) % 97 + 1, b[-3] % 50 + 1, 511]
    return out


def _write_folder(root, classes, per_class, size, seed=0):
    rng = np.random.default_rng(seed)
    for c in classes:
        (root / c).mkdir(parents=True)
        for i in range(per_class):
            Image.fromarray(rng.integers(0, 256, (size[0], size[1], 3), dtype=np.uint8)
                            ).save(root / c / f"{i}.png")
    return str(root)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return _write_folder(tmp_path_factory.mktemp("zs"), CLASSES, 5, (48, 40))


def test_templates_are_jax_s():
    assert tzs.DEFAULT_TEMPLATES == jzs.DEFAULT_TEMPLATES
    got = tzs.imagenet_templates()
    assert len(got) == 80 and got == jzs.imagenet_templates()


@pytest.mark.parametrize("templates,batch_size", [
    ("default", 256), ("imagenet", 256), ("default", 10)])
def test_classifier_matches_jax(models, templates, batch_size):
    jm, tm, _ = models
    tpl = jzs.DEFAULT_TEMPLATES if templates == "default" else jzs.imagenet_templates()
    want = np.asarray(jzs.build_zero_shot_classifier(jm, tok, CLASSES, tpl,
                                                     batch_size=batch_size))
    got = tzs.build_zero_shot_classifier(tm, tok, CLASSES, tpl, batch_size=batch_size)
    assert got.shape == (3, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("top_k", [1, 2, 5])
def test_classify_matches_jax(top_k):
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(16, 8)).astype(np.float32)
    clf = rng.normal(size=(4, 8)).astype(np.float32)
    clf /= np.linalg.norm(clf, axis=-1, keepdims=True)
    want = np.asarray(jzs.classify(jnp.asarray(emb), jnp.asarray(clf), top_k=top_k))
    got = tzs.classify(torch.from_numpy(emb), torch.from_numpy(clf), top_k=top_k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (16, min(top_k, 4))


def test_accuracy_matches_jax(models, folder):
    from debias_vision_lang_tpu.data.loader import HostLoader as JHostLoader

    jm, tm, _ = models
    ds = tcli.FolderDataset(folder)
    assert ds.class_names == CLASSES
    kw = {"batch_size": 4, "num_workers": 2, "native_n_px": 32}
    want = jzs.zero_shot_accuracy(jm, tok, JHostLoader(ds, **kw), ds.class_names,
                                  n_px=32, dtype="float32")
    got = tzs.zero_shot_accuracy(tm, tok, HostLoader(ds, **kw), ds.class_names, n_px=32)
    assert got == want and got["n"] == 15


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int8-text"])
def test_kernel_rungs_match_a_numpy_recount(models, folder, dtype):
    """top-1 / top-5 on the kernels' rungs equal a recount from the port's
    own embeddings and classifier, and the image tower runs at the rung."""
    from debias_vision_lang_torch.ops.quant import resolve_compute

    _, tm, cfg = models
    ds = tcli.FolderDataset(folder)
    loader = HostLoader(ds, batch_size=4, num_workers=2, native_n_px=32)
    got = tzs.zero_shot_accuracy(tm, tok, loader, ds.class_names, n_px=32, dtype=dtype)
    wrapped, dt = resolve_compute(tm, dtype)
    clf = tzs.build_zero_shot_classifier(wrapped, tok, ds.class_names).numpy()
    hits1 = hits5 = 0
    for batch in loader:
        x = preprocess_batch(torch.from_numpy(batch.images), 32,
                             mean=cfg.vision.image_mean, std=cfg.vision.image_std)
        with torch.no_grad():
            emb = wrapped.encode_image(x, dtype=dt).float().numpy()[: batch.num_valid]
        emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
        order = np.argsort(-(emb @ clf.T), axis=-1, kind="stable")
        labels = batch.labels[: batch.num_valid]
        hits1 += int((order[:, 0] == labels).sum())
        hits5 += int((order[:, :5] == labels[:, None]).any(-1).sum())
    assert got == {"top1": hits1 / 15, "top5": hits5 / 15, "n": 15}
    assert got["top5"] == 1.0  # three classes


def test_empty_loader_raises(models, tmp_path):
    _, tm, _ = models
    (tmp_path / "empty").mkdir()
    ds = tcli.FolderDataset(str(tmp_path))
    with pytest.raises(ValueError, match="yielded no images"):
        tzs.zero_shot_accuracy(tm, tok, HostLoader(ds, batch_size=4, native_n_px=32),
                               ["empty"], n_px=32)


@pytest.mark.parametrize("kw,rung", [({"dtype": "auto"}, "int8")])
def test_auto_is_the_family_rung(models, folder, kw, rung):
    """"auto" is the int8 rung for the ViT and SLIP towers (JAX's
    resolve_rung), with the same top-1 / top-5 as an explicit "int8"."""
    from debias_vision_lang_tpu.ops.quant import resolve_rung as jresolve_rung
    from debias_vision_lang_torch.ops.quant import resolve_rung

    jm, tm, _ = models
    assert resolve_rung(tm, kw["dtype"]) == jresolve_rung(jm, kw["dtype"]) == rung
    ds = tcli.FolderDataset(folder)
    got = {dt: tzs.zero_shot_accuracy(tm, tok, HostLoader(ds, batch_size=4, native_n_px=32),
                                      CLASSES, n_px=32, dtype=dt)
           for dt in (kw["dtype"], rung)}
    assert got[kw["dtype"]] == got[rung] and got[rung]["n"] == 15


def test_mesh_equals_one_device(models, folder):
    """A CPU mesh of 8 slots (batches of 4: every one ragged) and "auto"
    (one slot) give the unsharded call's top-1 / top-5 and JAX's mesh call's."""
    from debias_vision_lang_tpu.data.loader import HostLoader as JHostLoader
    from debias_vision_lang_tpu.parallel.mesh import create_mesh as jcreate
    from debias_vision_lang_torch.parallel import create_mesh

    jm, tm, _ = models
    ds = tcli.FolderDataset(folder)
    kw = {"batch_size": 4, "num_workers": 2, "native_n_px": 32}
    want = tzs.zero_shot_accuracy(tm, tok, HostLoader(ds, **kw), CLASSES, n_px=32)
    for mesh in (create_mesh(devices=[torch.device("cpu")] * 8), "auto"):
        got = tzs.zero_shot_accuracy(tm, tok, HostLoader(ds, **kw), CLASSES, n_px=32,
                                     mesh=mesh)
        assert got == want
    assert want == jzs.zero_shot_accuracy(jm, tok, JHostLoader(ds, **kw), CLASSES, n_px=32,
                                          mesh=jcreate(), dtype="float32")


def test_cli_zero_shot_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``zero-shot --device cpu --random-weights`` end to end on a SLIP
    ViT-B/16 (a toy BPE vocabulary stands in for CLIP's) over 224 px PNGs."""
    from debias_vision_lang_torch.text import tokenizer as ttok

    vocab = tmp_path / "bpe.txt.gz"
    with gzip.open(vocab, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\nt h\nth e</w>\na </w>\n")
    monkeypatch.setattr(ttok, "BPE_VOCAB_PATH", vocab)
    data = _write_folder(tmp_path / "data", ["bird", "ship"], 2, (224, 224), seed=5)
    tcli.main(["zero-shot", "--device", "cpu", "--random-weights", "--data-path", data,
               "--model", "facebookresearch/SLIP/ViT-B/16", "--batch-size", "4"])
    out = capsys.readouterr().out
    acc = json.loads(out[out.index("{"):])
    assert set(acc) == {"top1", "top5", "n"} and acc["n"] == 4
    assert acc["top5"] == 1.0 and 0.0 <= acc["top1"] <= 1.0
