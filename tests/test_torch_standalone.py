"""The PyTorch port stands alone: it imports nothing of the JAX package, and
its own copies of what it shares with it (``core/`` configuration, registry
and paths, ``native/`` host ingest, ``data/datasets.py``, the ``text/`` BPE
tokenizer, ``metrics/oracle.py``, the prompt assets) give the JAX
originals' answers.  Its entry points run on the card unless given
``device="cpu"``, and raise without one.  CPU only."""

import ast
import dataclasses
import pathlib

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from debias_vision_lang_torch.core import config as tconfig
from debias_vision_lang_torch.core import paths as tpaths
from debias_vision_lang_torch.core import registry as tregistry
from debias_vision_lang_tpu.core import config as jconfig
from debias_vision_lang_tpu.core import paths as jpaths
from debias_vision_lang_tpu.core import registry as jregistry

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "debias_vision_lang_torch"
PORT_SOURCES = sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py")) + [
    "chip_smoke.py", "profile_train.py"]
CONFIGS = ["VisionConfig", "TextConfig", "CLIPConfig", "DebiasConfig", "AdversaryConfig",
           "EvalConfig", "TrainConfig"]
FORBIDDEN = ("jax", "jaxlib", "optax", "debias_vision_lang_tpu")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_every_port_module_is_scanned():
    for rel in ("debias_vision_lang_torch/train/efficacy.py",
                "debias_vision_lang_torch/utils/fingerprint.py",
                *(f"debias_vision_lang_torch/serve/{m}.py"
                  for m in ("__init__", "batcher", "engine", "server")),
                "debias_vision_lang_torch/hub/__init__.py",
                "debias_vision_lang_torch/hub/hub.py",
                "debias_vision_lang_torch/cli.py",
                "debias_vision_lang_torch/__main__.py",
                "debias_vision_lang_torch/models/frozen_in_time.py",
                "debias_vision_lang_torch/data/video.py",
                "debias_vision_lang_torch/parallel/__init__.py",
                "debias_vision_lang_torch/parallel/mesh.py",
                "debias_vision_lang_torch/metrics/distributed.py"):
        assert rel in PORT_SOURCES


@pytest.mark.parametrize("rel", PORT_SOURCES)
def test_source_imports_nothing_of_jax(rel):
    tree = ast.parse((REPO / rel).read_text(), filename=rel)
    bad = [m for m in _imported_modules(tree) if m.split(".")[0] in FORBIDDEN]
    assert bad == [], f"{rel} imports {bad}"


# ---------------------------------------------------------------------------
# The copies against the JAX originals
# ---------------------------------------------------------------------------


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = f.default_factory()
        else:
            out[f.name] = dataclasses.MISSING
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_config_fields_and_defaults(name):
    tcls, jcls = getattr(tconfig, name), getattr(jconfig, name)
    assert tcls is not jcls
    assert [f.name for f in dataclasses.fields(tcls)] == [f.name for f in dataclasses.fields(jcls)]
    tdef, jdef = _defaults(tcls), _defaults(jcls)
    for key in jdef:
        if dataclasses.is_dataclass(jdef[key]):
            assert dataclasses.asdict(tdef[key]) == dataclasses.asdict(jdef[key]), key
        else:
            assert tdef[key] == jdef[key], key


@pytest.mark.parametrize("cfg", [
    {"NUM_DEBIAS_TOKENS": 3, "DEBIAS_POS": "append", "N_TRAIN_TXT_LAYERS": 1},
    {"ADV_N_INPUT": 319, "ADV_HIDDEN_SIZE": 32, "ADV_N_OUTPUT": 2},
    {}])
def test_dotdict_converters_agree(cfg):
    for conv in ("debias_config_from_dotdict", "adversary_config_from_dotdict"):
        if conv.startswith("adversary") and "ADV_N_INPUT" not in cfg:
            continue
        got = getattr(tconfig, conv)(tconfig.Dotdict(cfg))
        want = getattr(jconfig, conv)(jconfig.Dotdict(cfg))
        assert type(got).__module__.startswith("debias_vision_lang_torch")
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_registry_lists_agree():
    for name in ("VALID_MODELS", "VALID_CLIP_MODELS"):
        assert getattr(tregistry, name) == getattr(jregistry, name)
    for name in ("CLIP_ARCHS", "SLIP_ARCHS", "FIT_ARCHS"):
        assert list(getattr(tregistry, name)) == list(getattr(jregistry, name))


@pytest.mark.parametrize("model", jregistry.VALID_MODELS + ["ViT-B/16", "RN50"])
def test_registry_entries_and_aliases_agree(model):
    got, want = tregistry.resolve_arch(model), jregistry.resolve_arch(model)
    assert isinstance(got, tconfig.CLIPConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tregistry.alias_name(model) == jregistry.alias_name(model)


def test_registry_rejects_as_jax_does():
    with pytest.raises(NotImplementedError, match="not found"):
        tregistry.resolve_arch("nonsense/model")


def test_paths_same_names_and_assets(monkeypatch, tmp_path):
    for name in ("DATA_PATH", "FAIRFACE_DATA_PATH", "UTKFACE_DATA_PATH", "PROMPT_DATA_PATH",
                 "BPE_VOCAB_PATH"):
        assert getattr(tpaths, name) == getattr(jpaths, name), name
    for asset in ("prompt_templates.csv", "zero_shot_templates_imagenet.txt"):
        assert tpaths.resolve_asset(asset).read_bytes() == jpaths.resolve_asset(asset).read_bytes()
        # without the repo-root assets the port finds its own copy
        monkeypatch.setattr(tpaths, "DATA_PATH", tmp_path)
        found = tpaths.resolve_asset(asset)
        assert found.parent == PORT / "assets"
        assert found.read_bytes() == jpaths.resolve_asset(asset).read_bytes()
        monkeypatch.undo()


def _code_nodes(rel):
    """{name: ast dump} of a module's top-level statements, docstrings
    stripped (comments are not in the tree): the code, not its prose."""
    tree = ast.parse((REPO / rel).read_text(), filename=rel)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    out = {}
    for i, node in enumerate(tree.body):
        name = getattr(node, "name", None)
        if name is None and isinstance(node, ast.Assign):
            name = ast.unparse(node.targets[0])
        out[name or f"<{type(node).__name__} {i}>"] = ast.dump(node)
    return out


def test_batcher_copy_is_the_original():
    got = _code_nodes("debias_vision_lang_torch/serve/batcher.py")
    assert got == _code_nodes("debias_vision_lang_tpu/serve/batcher.py")


def test_server_copy_is_the_original():
    """Every route, status code, error string, limit, the handler, auth, TLS
    and SO_REUSEPORT are the JAX server's code.  What differs: ``serve_forever``
    (``device``, and ``mesh="auto"`` over that device's type) and the listen backlog (``_Server``,
    ``LISTEN_BACKLOG``, the base of ``_ReusePortServer`` and ``make_server``'s
    class), which the JAX server leaves at the stdlib's 5."""
    got = _code_nodes("debias_vision_lang_torch/serve/server.py")
    want = _code_nodes("debias_vision_lang_tpu/serve/server.py")
    assert sorted(set(got) - set(want)) == ["LISTEN_BACKLOG", "_Server"]
    assert set(want) <= set(got)
    differ = sorted(k for k in want if got[k] != want[k])
    assert differ == ["_ReusePortServer", "make_server", "serve_forever"]


def test_hub_registry_copy_is_the_original():
    from debias_vision_lang_torch.hub import hub as thub
    from debias_vision_lang_tpu.data.download import PRETRAINED_PROMPTS

    assert thub.PRETRAINED_PROMPTS == PRETRAINED_PROMPTS
    assert thub.PRETRAINED_PROMPTS is not PRETRAINED_PROMPTS


def test_port_assets_are_the_jax_packages():
    for asset in ("prompt_templates.csv", "zero_shot_templates_imagenet.txt"):
        assert ((PORT / "assets" / asset).read_bytes()
                == (REPO / "debias_vision_lang_tpu" / "assets" / asset).read_bytes())


def test_gen_prompts_from_the_port_copy(monkeypatch, tmp_path):
    from debias_vision_lang_torch.eval import measure as tmeasure
    from debias_vision_lang_tpu.eval.measure import gen_prompts as jgen

    monkeypatch.setattr(tpaths, "DATA_PATH", tmp_path)
    assert tmeasure.gen_prompts() == jgen()


TOY_MERGES = [("t", "h"), ("th", "e</w>"), ("p", "e"), ("pe", "r"), ("per", "son</w>"),
              ("a", "</w>"), ("g", "o"), ("go", "o"), ("goo", "d</w>")]


@pytest.mark.parametrize("texts", [
    ["a good person", "the person"], ["A  GOOD\tperson!!", "it's 42 persons"],
    ["café naïve", "<|startoftext|> x"]])
def test_tokenizer_same_ids(texts):
    from debias_vision_lang_torch.text.tokenizer import ClipTokenizer as TTok
    from debias_vision_lang_tpu.text.tokenizer import ClipTokenizer as JTok

    got, want = TTok(TOY_MERGES, context_length=16), JTok(TOY_MERGES, context_length=16)
    np.testing.assert_array_equal(got(texts), want(texts))
    assert got.encode(texts[0]) == want.encode(texts[0])


def test_tokenizer_truncation_agrees():
    from debias_vision_lang_torch.text.tokenizer import ClipTokenizer as TTok
    from debias_vision_lang_tpu.text.tokenizer import ClipTokenizer as JTok

    long = ["a good person " * 10]
    np.testing.assert_array_equal(TTok(TOY_MERGES, 8)(long, truncate=True),
                                  JTok(TOY_MERGES, 8)(long, truncate=True))
    with pytest.raises(RuntimeError):
        TTok(TOY_MERGES, 8)(long)


def test_bpe_loader_is_the_ports(monkeypatch, tmp_path):
    from debias_vision_lang_torch import text

    monkeypatch.setattr("debias_vision_lang_torch.text.tokenizer.BPE_VOCAB_PATH",
                        tmp_path / "absent.txt.gz")
    assert text.load_bpe_tokenizer() is None  # missing vocab: no BPE, no error


def _write_fairface(root, n=126, px=16, seed=0):
    rng = np.random.default_rng(seed)
    races = ["White", "Southeast Asian", "Middle Eastern", "Black", "Indian",
             "Latino_Hispanic", "East Asian"]
    ages = ["0-2", "3-9", "10-19", "20-29", "30-39", "40-49", "50-59", "60-69",
            "more than 70"]
    (root / "imgs" / "train_val" / "s").mkdir(parents=True)
    for mode in ("train", "val"):
        rows = []
        for i in range(n):
            f = f"s/{mode}_{(i * 5) % n}.jpg"  # unsorted: both sort by file
            Image.fromarray(rng.integers(0, 256, (px + i % 5, px, 3), dtype=np.uint8)).save(
                root / "imgs" / "train_val" / f)
            # every (age, race, gender) appears, and gender balances exactly
            rows.append({"file": f, "age": ages[i % 9],
                         "gender": "Male" if i % 2 else "Female", "race": races[i % 7]})
        (root / "labels" / mode).mkdir(parents=True)
        pd.DataFrame(rows).to_csv(root / "labels" / mode / f"{mode}_labels.csv", index=False)
    return root


@pytest.fixture(scope="module")
def fairface_root(tmp_path_factory):
    return _write_fairface(tmp_path_factory.mktemp("ff_standalone"))


@pytest.mark.parametrize("iat,kw", [
    ("gender", {"mode": "val"}), ("race", {"mode": "val"}), ("age", {"mode": "train"}),
    ("gender", {"mode": "train", "_n_samples": 15}),
    ("gender", {"mode": "train", "equal_split": False, "_n_samples": 0.5}),
    ("race", {"mode": "train", "equal_split": False})])
def test_fairface_same_rows(fairface_root, iat, kw):
    from debias_vision_lang_torch.data.datasets import FairFace as TFF
    from debias_vision_lang_tpu.data.datasets import FairFace as JFF

    got = TFF(iat_type=iat, data_path=fairface_root, download=False, **kw)
    want = JFF(iat_type=iat, data_path=fairface_root, download=False, **kw)
    pd.testing.assert_frame_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.iat_labels, want.iat_labels)
    assert got.n_iat_classes == want.n_iat_classes
    assert got._img_fnames == want._img_fnames
    np.testing.assert_array_equal(got.load_image(0), want.load_image(0))
    assert got[1].iat_label == want[1].iat_label


def test_utkface_same_rows(tmp_path):
    from debias_vision_lang_torch.data.datasets import UTKFace as TU
    from debias_vision_lang_tpu.data.datasets import UTKFace as JU

    rng = np.random.default_rng(1)
    for i, name in enumerate(["25_0_1_a.jpg", "3_1_0_b.jpg", "71_1_4_c.jpg", "40_0_2_d.jpg",
                              "bad_name.jpg", "30_1_3_e.jpg", "9_0_9_f.jpg", "16_1_1_g.jpg"]):
        Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)).save(tmp_path / name)
    for split in (False, True):
        got = TU(iat_type="gender", data_path=tmp_path, download=False, equal_split=split)
        want = JU(iat_type="gender", data_path=tmp_path, download=False, equal_split=split)
        pd.testing.assert_frame_equal(got.labels, want.labels)
        np.testing.assert_array_equal(got.iat_labels, want.iat_labels)


@pytest.mark.parametrize("cls", ["FairFace", "UTKFace"])
def test_datasets_never_download(cls, tmp_path):
    from debias_vision_lang_torch.data import datasets

    with pytest.raises(NotImplementedError, match="does not download"):
        getattr(datasets, cls)(iat_type="gender", data_path=tmp_path, download=True)


@pytest.fixture(scope="module")
def natives():
    from debias_vision_lang_torch import native as tnative
    from debias_vision_lang_tpu import native as jnative

    if not (tnative.available() and jnative.available()):
        pytest.skip(f"native ingest unavailable: {tnative.build_error()} / "
                    f"{jnative.build_error()}")
    return tnative, jnative


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpegs_standalone")
    rng = np.random.default_rng(5)
    paths = []
    for i, (h, w) in enumerate([(224, 224), (317, 211), (96, 300), (40, 41)]):
        p = d / f"{i}.jpg"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(p, quality=90)
        paths.append(str(p))
    return paths


def test_native_is_the_ports_own_build(natives):
    tnative, jnative = natives
    assert tnative is not jnative
    assert pathlib.Path(tnative._SRC).parent == PORT / "native"
    assert (PORT / "native" / "ingest.cc").read_bytes() == (
        REPO / "debias_vision_lang_tpu" / "native" / "ingest.cc").read_bytes()
    lib = pathlib.Path(tnative._lib_path())
    assert REPO / "debias_vision_lang_tpu" not in lib.parents


def test_native_decode_bytes_agree(natives, jpegs):
    tnative, jnative = natives
    for p in jpegs:
        blob = open(p, "rb").read()
        np.testing.assert_array_equal(tnative.decode_jpeg(blob), jnative.decode_jpeg(blob))
        assert tnative.jpeg_dims(blob) == jnative.jpeg_dims(blob)


@pytest.mark.parametrize("size", [(224, 224), (50, 70), (7, 300)])
def test_native_resize_bytes_agree(natives, size):
    tnative, jnative = natives
    img = np.random.default_rng(2).integers(0, 256, (120, 97, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tnative.resize_bicubic_u8(img, *size),
                                  jnative.resize_bicubic_u8(img, *size))


@pytest.mark.parametrize("n_px", [32, 224])
def test_native_crop_and_batch_bytes_agree(natives, jpegs, n_px):
    tnative, jnative = natives
    for fn, kw in (("ingest_batch_files_u8", {}), ("ingest_batch_files_u8p", {"patch": 8}),
                   ("preprocess_batch_files", {})):
        got, ok_t = getattr(tnative, fn)(jpegs, n_px, nthreads=2, **kw)
        want, ok_j = getattr(jnative, fn)(jpegs, n_px, nthreads=2, **kw)
        np.testing.assert_array_equal(ok_t, ok_j)
        np.testing.assert_array_equal(got, want)
    img = jnative.decode_jpeg(open(jpegs[1], "rb").read())
    np.testing.assert_array_equal(tnative.preprocess_u8(img, n_px), jnative.preprocess_u8(img, n_px))


@pytest.mark.parametrize("evaluation", ["maxskew", "ndkl"])
@pytest.mark.parametrize("topn", [1.0, 0.25, 7])
def test_oracle_results_agree(evaluation, topn):
    from debias_vision_lang_torch.eval import measure as tmeasure
    from debias_vision_lang_torch.metrics import oracle as toracle
    from debias_vision_lang_tpu.metrics import oracle as joracle

    rng = np.random.default_rng(11)
    labels = rng.integers(0, 3, 40)
    img, prm = rng.normal(size=(40, 8)), rng.normal(size=(5, 8))
    img[3] = img[4]  # a tie
    want = joracle.eval_ranking_oracle(labels, img, prm, evaluation, topn)
    assert toracle.eval_ranking_oracle(labels, img, prm, evaluation, topn) == want
    got = tmeasure.eval_ranking(labels, img.astype(np.float32), prm.astype(np.float32),
                                evaluation, topn, engine="oracle")
    assert got == joracle.eval_ranking_oracle(labels, img.astype(np.float32),
                                              prm.astype(np.float32), evaluation, topn)


# ---------------------------------------------------------------------------
# Entry points run on the card unless given device="cpu"
# ---------------------------------------------------------------------------


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_model_loader_without_a_card_raises(no_card):
    from debias_vision_lang_torch.models.loader import model_loader

    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_loader("openai/CLIP/ViT-B/32", pretrained=False)


def test_model_loader_on_the_cpu_when_asked(no_card):
    from debias_vision_lang_torch.models.loader import model_loader

    model, _, _, alias = model_loader("openai/CLIP/ViT-B/32", pretrained=False, device="cpu")
    assert alias == "oai-clip-vit-b-32"
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_from_cfg_without_a_card_raises(no_card):
    from debias_vision_lang_torch.models.debias import DebiasCLIP

    with pytest.raises(RuntimeError, match="no CUDA device"):
        DebiasCLIP.from_cfg({"CLIP_ARCH": "openai/CLIP/ViT-B/32", "PRETRAINED": False})


def test_run_training_without_a_card_raises(no_card, tmp_path):
    from debias_vision_lang_torch.train.loop import run_training

    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(arch="openai/CLIP/ViT-B/32", pretrained=False, data_path=str(tmp_path),
                     epochs=1, progress=False)


def test_resolve_device():
    from debias_vision_lang_torch.utils.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
