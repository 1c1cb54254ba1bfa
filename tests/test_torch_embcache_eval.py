"""The port's ``measure_bias(opts={"cache_embeddings": path})`` against the JAX
package's, on the CPU.  The cache works as JAX's does (exact path, staged
write, a hit that builds no dataset and reads no image file, a key mismatch
that raises with JAX's message), and its key also holds a content digest of
the image tower (``utils/fingerprint.py``): a changed debias-token array
still hits, while a vision weight one float32 ulp away raises, where the
JAX package serves the stale metrics (shown here with the same cache use).
Metrics are compared at atol 1e-5 (the oracle bar); a hit must equal the
miss exactly, and the digest must be equal across copies, seeds, processes
and (``cuda``) the card."""

import copy
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from debias_vision_lang_tpu.core.config import (CLIPConfig, DebiasConfig,
                                                TextConfig, VisionConfig)
from debias_vision_lang_torch.eval import measure as tmeasure
from debias_vision_lang_torch.models import clip as tclip
from debias_vision_lang_torch.models.convert import params_from_jax, to_jax_tree
from debias_vision_lang_torch.models.debias import DebiasCLIP as TDebiasCLIP
from debias_vision_lang_torch.ops.quant import QuantizedCLIP
from debias_vision_lang_torch.utils.fingerprint import (image_tower_tensors,
                                                       params_fingerprint)
from debias_vision_lang_torch.vision.preprocess import Preprocess as TPreprocess
from torch_port_config import port_config

torch.set_num_threads(1)

CFG = CLIPConfig(
    name="tiny",
    vision=VisionConfig(kind="vit", image_size=32, patch_size=8, width=64,
                        layers=2, heads=2, embed_dim=32),
    text=TextConfig(vocab_size=512, context_length=77, width=32, layers=2,
                    heads=2, embed_dim=32))
TCFG = port_config(CFG)
OPTS = {"batch_size": 8, "num_workers": 2, "topn": 10}
ATOL = 1e-5


def tok(texts):
    """Deterministic toy tokenizer: SOT, two content ids, EOT (max id)."""
    out = np.zeros((len(texts), 77), np.int64)
    for i, t in enumerate(texts):
        b = t.encode()
        out[i, :4] = [510, sum(b) % 400 + 1, len(b) % 97 + 1, 511]
    return out


def _write_fairface(root, n=24, seed=42):
    img_dir = root / "imgs" / "train_val" / "val"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)).save(
            img_dir / f"{i}.jpg", quality=90)
        rows.append({"file": f"val/{i}.jpg", "age": ["20-29", "30-39"][i % 2],
                     "gender": "Male" if i % 2 == 0 else "Female",
                     "race": ["White", "Black", "Indian"][i % 3]})
    for mode in ("train", "val"):
        (root / "labels" / mode).mkdir(parents=True)
        pd.DataFrame(rows).to_csv(root / "labels" / mode / f"{mode}_labels.csv",
                                  index=False)
    return str(root)


@pytest.fixture
def fairface(tmp_path):
    """A fresh FairFace layout per test: tests delete its images."""
    return _write_fairface(tmp_path / "ff")


def _np_params(seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + 0.02 * rng.normal(size=a.shape)).astype(np.float32),
        to_jax_tree(tclip.init_clip_params(TCFG, torch.Generator().manual_seed(seed))))


def _models(np_params, deb):
    """(JAX DebiasCLIP, port DebiasCLIP) holding the same weights."""
    from debias_vision_lang_tpu.models.debias import DebiasCLIP as JDebiasCLIP

    dcfg = DebiasConfig(num_debias_tokens=2, hidden_dim=32)
    jmodel = JDebiasCLIP(clip_params=jax.tree.map(jnp.asarray, np_params),
                         debias_tokens=jnp.asarray(deb), clip_cfg=CFG, debias_cfg=dcfg)
    clip = tclip.CLIP(TCFG)
    clip.load_state_dict(params_from_jax(np_params, TCFG))
    return jmodel, TDebiasCLIP(clip, torch.from_numpy(deb), port_config(dcfg))


@pytest.fixture(scope="module")
def weights():
    return _np_params(), np.random.default_rng(0).normal(size=(2, 32)).astype(np.float32)


@pytest.fixture(scope="module")
def models(weights):
    return _models(*weights)


def _tmeasure(model, fairface, cache, **kw):
    opts = {**OPTS, "data_path": fairface, "cache_embeddings": cache, **kw}
    return tmeasure.measure_bias(model, TPreprocess(32), tok, "gender", opts=opts)


def _jmeasure(model, fairface, cache, **kw):
    from debias_vision_lang_tpu.eval.measure import measure_bias
    from debias_vision_lang_tpu.vision.preprocess import Preprocess

    opts = {**OPTS, "data_path": fairface, "cache_embeddings": cache, **kw}
    return measure_bias(model, Preprocess(32), tok, "gender", opts=opts)


def _assert_metrics_close(got, want):
    assert set(got) == set(want)
    for ev in want:
        for k in want[ev]:
            assert got[ev][k] == pytest.approx(want[ev][k], abs=ATOL), (ev, k)


def _forbid_datasets(monkeypatch, what="a cache hit built a dataset or a loader"):
    """From here on, any dataset or loader construction fails."""
    from debias_vision_lang_torch.data import datasets

    def refuse(*a, **k):
        raise AssertionError(what)

    monkeypatch.setattr(datasets, "FairFace", refuse)
    monkeypatch.setattr(datasets, "UTKFace", refuse)
    monkeypatch.setattr(tmeasure, "HostLoader", refuse)


class TestCacheAsJax:
    def test_miss_writes_the_exact_path_and_matches_jax(self, fairface, models, tmp_path):
        from debias_vision_lang_torch.data.datasets import FairFace

        jmodel, tmodel = models
        cache = str(tmp_path / "embcache")  # no .npz suffix: kept as given
        got = _tmeasure(tmodel, fairface, cache)
        assert os.path.exists(cache) and not os.path.exists(cache + ".npz")
        assert not os.path.exists(cache + ".part")
        with np.load(cache, allow_pickle=False) as data:
            assert set(data.files) == {"labels", "embeddings", "cache_key", "files"}
            key = json.loads(str(data["cache_key"]))
            files = data["files"].tolist()
            assert data["embeddings"].shape == (24, 32)
        ds = FairFace(mode="val", iat_type="gender", data_path=fairface, download=False)
        assert files == ds.labels["file"].tolist()
        assert key["params"] == params_fingerprint(image_tower_tensors(tmodel))
        assert {k: v for k, v in key.items() if k != "params"} == {
            "attribute": "gender", "dataset": "fairface", "mode": "val",
            "n_samples": None, "dtype": "float32", "equal_split": True,
            "data_path": fairface, "num_frames": None}
        _assert_metrics_close(got, _jmeasure(jmodel, fairface, str(tmp_path / "j.npz")))

    def test_hit_equals_miss_and_builds_no_dataset(self, fairface, models, tmp_path,
                                                   monkeypatch):
        _, tmodel = models
        cache = str(tmp_path / "c.npz")
        first = _tmeasure(tmodel, fairface, cache)
        shutil.rmtree(os.path.join(fairface, "imgs"))  # the image files are gone
        _forbid_datasets(monkeypatch)
        assert _tmeasure(tmodel, fairface, cache) == first

    def test_hit_serves_another_topn_and_evaluation(self, fairface, models, tmp_path):
        _, tmodel = models
        cache = str(tmp_path / "c.npz")
        _tmeasure(tmodel, fairface, cache, evaluations=("ndkl",), topn=1.0)
        hit = _tmeasure(tmodel, fairface, cache, evaluations=("maxskew",), topn=0.5)
        fresh = tmeasure.measure_bias(tmodel, TPreprocess(32), tok, "gender",
                                      opts={**OPTS, "data_path": fairface,
                                            "evaluations": ("maxskew",), "topn": 0.5})
        assert hit == fresh

    @pytest.mark.parametrize("change", [
        {"attribute": "race"}, {"dataset": "utkface"}, {"n_samples": 8},
        {"equal_split": False}, {"mode": "train"}])
    def test_selection_mismatch_raises_as_in_jax(self, fairface, models, tmp_path,
                                                 change):
        jmodel, tmodel = models
        for measure, model, name in ((_tmeasure, tmodel, "t.npz"),
                                     (_jmeasure, jmodel, "j.npz")):
            cache = str(tmp_path / name)
            measure(model, fairface, cache)
            attribute = change.get("attribute", "gender")
            kw = {k: v for k, v in change.items() if k != "attribute"}
            opts = {**OPTS, "data_path": fairface, "cache_embeddings": cache, **kw}
            if measure is _tmeasure:
                call = lambda: tmeasure.measure_bias(model, TPreprocess(32), tok,  # noqa: E731
                                                     attribute, opts=opts)
            else:
                from debias_vision_lang_tpu.eval.measure import measure_bias
                from debias_vision_lang_tpu.vision.preprocess import Preprocess

                call = lambda: measure_bias(model, Preprocess(32), tok,  # noqa: E731
                                            attribute, opts=opts)
            with pytest.raises(ValueError, match="the cached labels would be wrong"):
                call()

    def test_rung_is_in_the_key(self, fairface, models, tmp_path):
        _, tmodel = models
        cache = str(tmp_path / "c.npz")
        _tmeasure(tmodel, fairface, cache, dtype="bfloat16")
        for dtype in ("float32", "int8"):
            with pytest.raises(ValueError, match="was written for"):
                _tmeasure(tmodel, fairface, cache, dtype=dtype)


class TestCacheKeyedByTheTower:
    def test_changed_debias_tokens_still_hit(self, fairface, weights, tmp_path,
                                             monkeypatch):
        np_params, deb = weights
        _, tmodel = _models(np_params, deb)
        cache = str(tmp_path / "c.npz")
        _tmeasure(tmodel, fairface, cache)
        _, other = _models(np_params, deb + 1.0)
        fresh = _tmeasure(other, fairface, None)
        _forbid_datasets(monkeypatch, "the debias tokens missed the cache")
        assert _tmeasure(other, fairface, cache) == fresh

    def test_text_tower_change_still_hits(self, fairface, weights, tmp_path):
        np_params, deb = weights
        _, tmodel = _models(np_params, deb)
        cache = str(tmp_path / "c.npz")
        _tmeasure(tmodel, fairface, cache)
        with torch.no_grad():
            tmodel.clip.text.text_projection.add_(0.5)
            tmodel.clip.logit_scale.add_(1.0)
        _assert_metrics_close(_tmeasure(tmodel, fairface, cache),
                              _tmeasure(tmodel, fairface, None))

    def test_vision_weight_change_raises_where_jax_serves_stale(self, fairface, weights,
                                                               tmp_path):
        np_params, deb = weights
        jmodel, tmodel = _models(np_params, deb)
        tcache, jcache = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
        t_first = _tmeasure(tmodel, fairface, tcache)
        j_first = _jmeasure(jmodel, fairface, jcache)

        # the port: one vision weight one float32 ulp away misses the key
        ulp = copy.deepcopy(tmodel)
        with torch.no_grad():
            w = ulp.clip.visual.resblocks[1].mlp.w1.view(-1)
            w[7] = torch.nextafter(w[7], torch.tensor(np.inf))
        with pytest.raises(ValueError, match="the cached labels would be wrong"):
            _tmeasure(ulp, fairface, tcache)

        # a checkpoint swap: other vision weights, same text tower and tokens
        swapped = {**np_params, "visual": _np_params(seed=7)["visual"]}
        jswap, tswap = _models(swapped, deb)
        with pytest.raises(ValueError, match="the cached labels would be wrong"):
            _tmeasure(tswap, fairface, tcache)
        # the JAX package answers from the cache: the old tower's metrics
        stale = _jmeasure(jswap, fairface, jcache)
        assert stale == j_first
        true = _jmeasure(jswap, fairface, None)
        assert true != stale
        _assert_metrics_close(_tmeasure(tswap, fairface, None), true)
        _assert_metrics_close(t_first, j_first)


class TestFingerprint:
    def test_equal_across_clone_and_seed(self):
        a = tclip.CLIP(TCFG)
        a.load_state_dict(tclip.init_clip_params(TCFG, torch.Generator().manual_seed(3)))
        b = tclip.CLIP(TCFG)
        b.load_state_dict(tclip.init_clip_params(TCFG, torch.Generator().manual_seed(3)))
        want = params_fingerprint(image_tower_tensors(a))
        assert params_fingerprint({k: v.clone() for k, v in
                                   image_tower_tensors(a).items()}) == want
        assert params_fingerprint(image_tower_tensors(copy.deepcopy(a))) == want
        assert params_fingerprint(image_tower_tensors(b)) == want
        c = tclip.CLIP(TCFG)
        c.load_state_dict(tclip.init_clip_params(TCFG, torch.Generator().manual_seed(4)))
        assert params_fingerprint(image_tower_tensors(c)) != want

    def test_equal_in_a_subprocess(self):
        code = (
            "import sys, torch\n"
            f"sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})\n"
            "from debias_vision_lang_torch.core.config import (CLIPConfig, "
            "TextConfig, VisionConfig)\n"
            f"TCFG = CLIPConfig(name='tiny', vision=VisionConfig(**{CFG.vision.__dict__!r}), "
            f"text=TextConfig(**{CFG.text.__dict__!r}))\n"
            "from debias_vision_lang_torch.models import clip as tclip\n"
            "from debias_vision_lang_torch.utils.fingerprint import "
            "image_tower_tensors, params_fingerprint\n"
            "m = tclip.CLIP(TCFG)\n"
            "m.load_state_dict(tclip.init_clip_params(TCFG, torch.Generator().manual_seed(3)))\n"
            "print(params_fingerprint(image_tower_tensors(m)))\n")
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             env=env, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        m = tclip.CLIP(TCFG)
        m.load_state_dict(tclip.init_clip_params(TCFG, torch.Generator().manual_seed(3)))
        assert out.stdout.strip().splitlines()[-1] == params_fingerprint(
            image_tower_tensors(m))

    def test_covers_the_vision_tower_only(self, models):
        _, tmodel = models
        names = set(image_tower_tensors(tmodel))
        assert names == {f"visual.{k}" for k in tmodel.clip.visual.state_dict()}
        assert image_tower_tensors(QuantizedCLIP(tmodel)).keys() == names
        assert image_tower_tensors(tmodel.clip).keys() == names
        want = params_fingerprint(image_tower_tensors(tmodel))
        assert params_fingerprint(image_tower_tensors(QuantizedCLIP(tmodel))) == want

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8,
                                       torch.int64, torch.bool])
    def test_every_element_counts(self, dtype):
        """A change of any one element, at any position, changes the digest;
        so does a swap of two elements and a reshape."""
        g = torch.Generator().manual_seed(0)
        t = (torch.rand(5, 7, generator=g) * 100).to(dtype)
        base = params_fingerprint({"t": t})
        for i in range(t.numel()):
            u = t.clone().view(-1)
            u[i] = (u[i] == 0) if dtype == torch.bool else u[i] + 1
            assert params_fingerprint({"t": u.view(5, 7)}) != base, i
        u = t.clone().view(-1)
        u[[0, 1]] = u[[1, 0]]
        if not torch.equal(u[:2], t.view(-1)[:2]):
            assert params_fingerprint({"t": u.view(5, 7)}) != base
        assert params_fingerprint({"t": t.reshape(7, 5)}) != base
        assert params_fingerprint({"u": t}) != base

    @pytest.mark.parametrize("a, b", [(0x3F800000, 0xBF7FFFFF),  # 1.0, -prevfloat(1.0)
                                      (0x00000000, 0x7FFFFFFF),  # 0.0, a NaN
                                      (0x00000001, 0x80000000)])  # 2^-149, -0.0
    def test_words_p_apart_differ(self, a, b):
        """Two 32-bit words exactly 2^31 - 1 apart (the sums' modulus), at
        every position of a tensor, give different digests."""
        g = torch.Generator().manual_seed(1)
        t = torch.randint(0, 2**31 - 1, (9, 5), generator=g, dtype=torch.int32)
        for i in range(t.numel()):
            u, w = t.clone().view(-1), t.clone().view(-1)
            u[i], w[i] = np.int32(np.uint32(a)), np.int32(np.uint32(b))
            assert (params_fingerprint({"t": u.view(torch.float32)})
                    != params_fingerprint({"t": w.view(torch.float32)})), i

    def test_bucketing_does_not_change_the_digest(self, monkeypatch):
        """The digest is the same whether the tensors share one fused pass or
        take one each, and a tensor longer than one row of halves counts
        every row."""
        import debias_vision_lang_torch.utils.fingerprint as F

        g = torch.Generator().manual_seed(2)
        ts = {f"w{i}": torch.randn(n, generator=g)
              for i, n in enumerate((0, 1, 3, 2 * F._K + 1, 5 * F._K))}
        ts["b"] = torch.ones(7, dtype=torch.int8)
        want = params_fingerprint(ts)
        monkeypatch.setattr(F, "_BUCKET", 1)
        assert params_fingerprint(ts) == want
        big = ts["w4"].clone()
        big[-1] += 1
        assert params_fingerprint({**ts, "w4": big}) != want

    @pytest.mark.cuda
    def test_equal_on_the_card(self, models):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: compares the digest on the card with "
                        "the CPU's")
        _, tmodel = models
        want = params_fingerprint(image_tower_tensors(tmodel))
        on_card = copy.deepcopy(tmodel).to("cuda")
        assert params_fingerprint(image_tower_tensors(on_card)) == want
