"""The port's adversary ablation (``debias_vision_lang_torch/train/efficacy.py``)
against the JAX package's, on the CPU, at small sizes:

* the vocabulary, ``word_tokenize`` and the prompt lists equal JAX's;
* ``build_world`` writes byte-identical files and returns identical arrays
  and captions for the same seed;
* ``pretrain_tiny_clip`` from JAX's init: the step-0 loss and every
  gradient within 1e-5 (absolute) of JAX's, and after 3 Adam steps the loss
  within 1e-4 and every parameter within 1e-4, but the key biases, whose
  exact gradient is 0: Adam scales their float noise to steps of about lr,
  so they are held to 3 x 2 lr;
* ``_fresh_model``'s tokens are JAX's bit for bit;
* ``measure_model`` on the same weights: metrics within 1e-5, the same
  probe accuracy, with and without an on-disk world;
* the two repairs of the JAX module: the cache's file list is held to
  ``val_ds`` row by row, and a world that fails the harness's
  preconditions is recorded as invalid with no arms run;
* a tiny two-arm ablation has JAX's record layout and one ``before``;
* from JAX's pretrained tower and JAX's adversary init, both arms of the
  port's ``run_arm`` follow JAX's: every eval of the NDKL curve within
  1e-4 (the full-size run is marked slow).

The full seed-0 ablation at the JAX module's defaults, held to
``tests/test_efficacy.py``'s bars, is marked slow, and expected to fail: the
port's seed-0 world is invalid on the CPU (see its mark)."""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debias_vision_lang_torch.models.convert import params_from_jax, to_jax_tree
from debias_vision_lang_torch.train import efficacy as T
from debias_vision_lang_tpu.train import efficacy as J

torch.set_num_threads(1)

GRAD_ATOL = 1e-5  # step-0 loss and gradients
LOSS3_ATOL = 1e-4  # the loss after 3 Adam steps
PARAM3_ATOL = 1e-4  # every parameter after 3 Adam steps but the key biases
# the key biases' exact gradient is 0 (a bias on every key of a query moves
# its scores alike), so both packages step them by float noise that Adam
# scales to about +-lr a step: after 3 steps they may part by 3 x 2 lr
KEY_BIAS3_ATOL = 3 * 2 * 2e-3
METRIC_ATOL = 1e-5  # the oracle bar
# JAX's run_ablation_experiment record layout (efficacy.py:545-632 there)
JAX_RECORD_KEYS = {"seeds", "config"}
JAX_ARM_KEYS = {"before", "after", "reduction", "train_summary", "curve"}
JAX_SUMMARY_KEYS = {"best_ndkl", "final_ndkl", "steps", "export", "checkpoint_dir",
                    "embed_cache", "embed_cache_disk"}
TINY = {"n_train": 64, "n_val": 32, "epochs": 1, "batch_size": 32, "eval_every": 1,
        "topk": 10}


def _tree_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


class TestVocabulary:
    def test_constants_and_prompts_equal_jax(self):
        for name in ("FEMALE_ADJS", "MALE_ADJS", "ADJECTIVES", "CONCEPTS", "VOCAB", "CTX",
                     "SOT", "EOT", "PX", "_WORD_IDS", "_FILLERS", "_RACES", "_AGES"):
            assert getattr(T, name) == getattr(J, name), name
        assert T.sensitive_prompts() == J.sensitive_prompts()
        assert T.probe_prompts() == J.probe_prompts()

    def test_word_tokenize_equals_jax(self):
        texts = (T.sensitive_prompts() + T.probe_prompts()
                 + ["a photo of a good female round person f3", "A  PHOTO of  person"])
        got, want = T.word_tokenize(texts), J.word_tokenize(texts)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("text,exc", [
        ("a photo of a wug person", KeyError),
        (" ".join(["a"] * 15), ValueError)])
    def test_word_tokenize_rejects_as_jax(self, text, exc):
        for mod in (T, J):
            with pytest.raises(exc):
                mod.word_tokenize([text])


@pytest.mark.parametrize("seed", [0, 1])
def test_build_world_is_byte_identical(tmp_path, seed):
    got = T.build_world(str(tmp_path / "t"), n_train=16, n_val=8, seed=seed)
    want = J.build_world(str(tmp_path / "j"), n_train=16, n_val=8, seed=seed)
    np.testing.assert_array_equal(got["train_images"], want["train_images"])
    assert got["train_images"].dtype == want["train_images"].dtype
    assert got["train_captions"] == want["train_captions"]

    def files(root):
        out = {}
        for d, _, names in os.walk(root):
            for n in names:
                p = os.path.join(d, n)
                out[os.path.relpath(p, root)] = open(p, "rb").read()
        return out

    tfiles, jfiles = files(str(tmp_path / "t")), files(str(tmp_path / "j"))
    assert len(tfiles) == 16 + 8 + 3  # JPEGs, two label CSVs, the captions CSV
    assert tfiles.keys() == jfiles.keys()
    for rel in tfiles:
        assert tfiles[rel] == jfiles[rel], rel
    link = os.path.join(got["pairs"], "images")
    assert os.path.realpath(link) == os.path.realpath(
        os.path.join(got["fairface"], "imgs", "train_val"))


# ---------------------------------------------------------------------------
# Pretraining
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_world(tmp_path_factory):
    root = tmp_path_factory.mktemp("efficacy_world")
    return T.build_world(str(root), n_train=48, n_val=24, seed=0)


@pytest.fixture(scope="module")
def jax_init():
    """JAX's pretraining init for seed 0 and its config."""
    from debias_vision_lang_tpu.models.clip import init_clip_params

    cfg = J.tiny_clip_cfg()
    return _tree_np(init_clip_params(jax.random.key(0), cfg)), cfg


def _jax_loss(params, images_u8, tokens, cfg):
    """The loss of the JAX module's pretraining step (its local loss_fn)."""
    from debias_vision_lang_tpu.models import clip as clip_model
    from debias_vision_lang_tpu.train.adversarial import clip_contrastive_loss
    from debias_vision_lang_tpu.vision.preprocess import preprocess_batch

    imgs = preprocess_batch(images_u8, cfg.vision.image_size, mean=cfg.vision.image_mean,
                            std=cfg.vision.image_std)
    img = clip_model.encode_image(params, imgs, cfg).astype(jnp.float32)
    txt = clip_model.encode_text(params, tokens, cfg).astype(jnp.float32)
    return clip_contrastive_loss(img, txt, params["logit_scale"])


def _port_model(np_tree):
    from debias_vision_lang_torch.models.clip import CLIP

    cfg = T.tiny_clip_cfg()
    model = CLIP(cfg)
    model.load_state_dict(params_from_jax(np_tree, cfg))
    return model, cfg


def test_pretrain_step0_loss_and_gradients_match_jax(small_world, jax_init):
    params, jcfg = jax_init
    images = small_world["train_images"][:16]
    tokens = J.word_tokenize(small_world["train_captions"][:16])
    want_loss, want_grads = jax.jit(jax.value_and_grad(_jax_loss), static_argnums=3)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(images), jnp.asarray(tokens), jcfg)

    model, cfg = _port_model(params)
    loss = T.pretrain_loss(model, torch.from_numpy(images),
                           torch.from_numpy(tokens).long(), cfg)
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= GRAD_ATOL
    got_grads = to_jax_tree({n: p.grad for n, p in model.named_parameters()})
    flat_want = dict(jax.tree_util.tree_flatten_with_path(_tree_np(want_grads))[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got_grads)[0])
    assert flat_got.keys() == flat_want.keys()
    for path, g in flat_want.items():
        np.testing.assert_allclose(flat_got[path], g, rtol=0, atol=GRAD_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_pretrain_three_adam_steps_match_jax(small_world, jax_init):
    params, jcfg = jax_init
    images, captions = small_world["train_images"], small_world["train_captions"]
    want, _ = J.pretrain_tiny_clip(images, captions, steps=3, batch_size=16, seed=0)
    got, cfg = T.pretrain_tiny_clip(images, captions, steps=3, batch_size=16, seed=0,
                                    params=params_from_jax(params, T.tiny_clip_cfg()),
                                    device="cpu")
    assert all(t.device.type == "cpu" for t in got.values())
    flat_want = dict(jax.tree_util.tree_flatten_with_path(_tree_np(want))[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(to_jax_tree(got))[0])
    flat_init = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    for path, w in flat_want.items():
        g, name = flat_got[path], jax.tree_util.keystr(path)
        if name.endswith("['bqkv']"):
            d = w.shape[-1] // 3  # q | k | v
            np.testing.assert_allclose(g[..., d:2 * d], w[..., d:2 * d], rtol=0,
                                       atol=KEY_BIAS3_ATOL, err_msg=name)
            g, w = np.delete(g, np.s_[d:2 * d], -1), np.delete(w, np.s_[d:2 * d], -1)
        np.testing.assert_allclose(g, w, rtol=0, atol=PARAM3_ATOL, err_msg=name)
    # the steps did move the weights (by about 3 lr)
    assert max(float(np.abs(w - flat_init[p]).max()) for p, w in flat_want.items()) > 1e-3

    tokens = J.word_tokenize(captions[:16])
    want_loss = float(_jax_loss(jax.tree.map(jnp.asarray, want), jnp.asarray(images[:16]),
                                jnp.asarray(tokens), jcfg))
    model, _ = _port_model(to_jax_tree(got))
    with torch.no_grad():
        got_loss = T.pretrain_loss(model, torch.from_numpy(images[:16]),
                                   torch.from_numpy(tokens).long(), cfg).item()
    assert abs(got_loss - want_loss) <= LOSS3_ATOL


def test_pretrain_takes_a_state_dict_and_needs_a_card_by_default(small_world, jax_init,
                                                                 monkeypatch):
    params, _ = jax_init
    images, captions = small_world["train_images"], small_world["train_captions"]
    model, _ = _port_model(params)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    a, _ = T.pretrain_tiny_clip(images, captions, steps=2, batch_size=16,
                                params=model.state_dict(), device="cpu")
    b, _ = T.pretrain_tiny_clip(images, captions, steps=2, batch_size=16,
                                params=model.state_dict(), device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(v, start[k]) for k, v in model.state_dict().items())
    assert any(not torch.equal(a[k], start[k]) for k in a)
    with pytest.raises(RuntimeError, match="Error.s. in loading state_dict"):
        T.pretrain_tiny_clip(images, captions, steps=1, batch_size=16, params=params,
                             device="cpu")  # a JAX tree: convert it first
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.pretrain_tiny_clip(images, captions, steps=1, batch_size=16)


# ---------------------------------------------------------------------------
# Models and measurement
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pretrained(small_world):
    """JAX's briefly pretrained tower: measurable, not degenerate, metrics."""
    params, cfg = J.pretrain_tiny_clip(small_world["train_images"],
                                       small_world["train_captions"], steps=20,
                                       batch_size=16, seed=0)
    return _tree_np(params), cfg


def test_fresh_model_tokens_are_jax_bit_for_bit(pretrained):
    params, jcfg = pretrained
    jm = J._fresh_model(jax.tree.map(jnp.asarray, params), jcfg, seed=3)
    tm = T._fresh_model(params_from_jax(params, T.tiny_clip_cfg()), T.tiny_clip_cfg(),
                        seed=3, device="cpu")
    got, want = tm.debias_tokens.detach().numpy(), np.asarray(jm.debias_tokens)
    assert got.shape == want.shape == (2, 64)
    assert got.tobytes() == want.tobytes()
    assert tm.debias_cfg.debias_pos == jm.debias_cfg.debias_pos == "prepend"


@pytest.fixture(scope="module")
def measured(small_world, pretrained):
    """(port, JAX) measure_model on the same weights, through the cache."""
    from debias_vision_lang_torch.data.datasets import FairFace as TFairFace
    from debias_vision_lang_tpu.data.datasets import FairFace as JFairFace

    params, jcfg = pretrained
    ff = small_world["fairface"]
    jm = J._fresh_model(jax.tree.map(jnp.asarray, params), jcfg, seed=0)
    tm = T._fresh_model(params_from_jax(params, T.tiny_clip_cfg()), T.tiny_clip_cfg(),
                        seed=0, device="cpu")
    tval = TFairFace(mode="val", iat_type="gender", data_path=ff, download=False)
    jval = JFairFace(mode="val", iat_type="gender", data_path=ff, download=False)
    return {"port": T.measure_model(tm, tval, topk=10, data_path=ff),
            "jax": J.measure_model(jm, jval, topk=10, data_path=ff),
            "models": (tm, jm), "val": (tval, jval)}


def _assert_measures_close(got, want):
    assert got.keys() == want.keys()
    assert got["probe_acc"] == want["probe_acc"]
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=METRIC_ATOL), k


def test_measure_model_matches_jax(measured):
    got, want = measured["port"], measured["jax"]
    assert set(got) == {"ndkl_eq_opp", "ndkl_dem_par", "maxskew@10_eq_opp",
                        "maxskew@10_dem_par", "probe_acc"}
    _assert_measures_close(got, want)
    assert 0 < got["probe_acc"] <= 1 and got["ndkl_eq_opp"] > 0


def test_measure_model_without_a_world_on_disk(measured):
    """The branch without ``data_path`` (the engines called directly) gives
    the measure_bias branch's numbers, and JAX's."""
    tm, jm = measured["models"]
    tval, jval = measured["val"]
    got = T.measure_model(tm, tval, topk=10)
    _assert_measures_close(got, measured["port"])
    _assert_measures_close(got, J.measure_model(jm, jval, topk=10))


def test_measure_model_holds_the_cache_rows_to_val_ds(small_world, measured, monkeypatch):
    from debias_vision_lang_torch.data.datasets import FairFace as TFairFace
    from debias_vision_lang_torch.eval import measure as tmeasure

    tm, _ = measured["models"]
    ff = small_world["fairface"]
    # a val_ds with other rows than measure_bias's (fewer) raises
    short = TFairFace(mode="val", iat_type="gender", data_path=ff, download=False,
                      _n_samples=20)
    with pytest.raises(RuntimeError, match="do not line up"):
        T.measure_model(tm, short, topk=10, data_path=ff)

    # the same rows in another order raise too (JAX's length-only guard
    # would pass them): reorder the file list the miss writes
    real = tmeasure.measure_bias

    def reordering(*args, **kw):
        out = real(*args, **kw)
        if "ndkl" not in kw["opts"]["evaluations"]:
            return out  # the hit
        path = kw["opts"]["cache_embeddings"]
        with np.load(path, allow_pickle=False) as data:
            arrays = {k: data[k] for k in data.files}
        arrays["files"] = arrays["files"][::-1].copy()
        with open(path, "wb") as f:
            np.savez(f, **arrays)
        return out

    monkeypatch.setattr(tmeasure, "measure_bias", reordering)
    with pytest.raises(RuntimeError, match="first differing at row 0"):
        T.measure_model(tm, measured["val"][0], topk=10, data_path=ff)


# ---------------------------------------------------------------------------
# The harness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("before,failed", [
    ({"ndkl_eq_opp": 0.3, "maxskew@50_eq_opp": 0.4, "probe_acc": 0.85}, []),
    ({"ndkl_eq_opp": 0.2, "maxskew@50_eq_opp": 0.4, "probe_acc": 0.9},
     ["ndkl_eq_opp > 0.2"]),
    ({"ndkl_eq_opp": 0.3, "maxskew@50_eq_opp": 0.3, "probe_acc": 0.5},
     ["maxskew@50_eq_opp > 0.3", "probe_acc >= 0.85"]),
    ({"ndkl_eq_opp": math.nan, "maxskew@50_eq_opp": 0.4, "probe_acc": 1.0},
     ["ndkl_eq_opp > 0.2"])])
def test_failed_preconditions(before, failed):
    assert T.failed_preconditions(before, topk=50) == failed


def test_invalid_world_is_recorded_without_arms(tmp_path, capsys):
    """pretrain_steps=0: an untrained tower, its concept probe at chance."""
    out_json = tmp_path / "out" / "ablation.json"
    T.main(["--ablation", "--seeds", "0", "--pretrain-steps", "0", "--n-train", "64",
            "--n-val", "32", "--batch-size", "32", "--topk", "10", "--device", "cpu",
            "--root", str(tmp_path / "root"), "--json-out", str(out_json)])
    printed = json.loads(out_json.read_text())
    assert set(printed) == {"0"} and set(printed["0"]) == {"invalid"}
    rec = printed["0"]["invalid"]
    assert "probe_acc >= 0.85" in rec["failed"]
    assert rec["before"]["probe_acc"] < 0.85
    assert set(rec["before"]) == {"ndkl_eq_opp", "ndkl_dem_par", "maxskew@10_eq_opp",
                                  "maxskew@10_dem_par", "probe_acc"}
    assert not any(n.startswith("ckpt") for n in os.listdir(tmp_path / "root" / "seed0"))
    assert '"invalid"' in capsys.readouterr().out


def test_tiny_ablation_record(tmp_path):
    res = T.run_ablation_experiment(str(tmp_path), seeds=(0,), pretrain_steps=50,
                                    device="cpu", **TINY)
    assert set(res) == JAX_RECORD_KEYS | {"invalid"}
    assert res["invalid"] == {}, res["invalid"]
    assert res["config"] == {**TINY, "pretrain_steps": 50}
    arms = res["seeds"][0]
    assert set(arms) == {"adversarial", "control"}
    for name, rec in arms.items():
        assert set(rec) == JAX_ARM_KEYS
        assert set(rec["train_summary"]) == JAX_SUMMARY_KEYS
        assert set(rec["reduction"]) == set(rec["before"]) - {"probe_acc"}
        assert rec["train_summary"]["steps"] == 2
        assert [c["step"] for c in rec["curve"]] == [1, 2]
        export = torch.load(rec["train_summary"]["export"], weights_only=True)
        assert type(export) is torch.Tensor and tuple(export.shape) == (2, 64)
        assert all(math.isfinite(v) for part in ("before", "after")
                   for v in rec[part].values())
    assert arms["adversarial"]["before"] == arms["control"]["before"]


def _arms_from_one_tower(root, seed, monkeypatch, *, n_train, n_val, pretrain_steps,
                         **arm_kw):
    """JAX's world and pretrained tower for ``seed``, then both arms in both
    packages from it, the port's adversary initialised with JAX's numbers:
    {(package, arm name): record}."""
    from debias_vision_lang_torch.data.datasets import FairFace as TFairFace
    from debias_vision_lang_torch.models.adversary import Adversary
    from debias_vision_lang_torch.models.convert import adversary_params_from_jax
    from debias_vision_lang_tpu.models.adversary import Adversary as JAdversary

    jworld, params, jcfg, jval = J.prepare_world(
        str(root / "j"), n_train=n_train, n_val=n_val, pretrain_steps=pretrain_steps,
        batch_size=arm_kw.get("batch_size", 64), seed=seed)
    tworld = T.build_world(str(root / "t"), n_train=n_train, n_val=n_val, seed=seed)
    tval = TFairFace(mode="val", iat_type="gender", data_path=tworld["fairface"],
                     download=False)
    tparams = params_from_jax(_tree_np(params), T.tiny_clip_cfg())
    jb = J.measure_model(J._fresh_model(params, jcfg, seed), jval,
                         topk=arm_kw["topk"], data_path=jworld["fairface"])
    tb = T.measure_model(T._fresh_model(tparams, T.tiny_clip_cfg(), seed, "cpu"), tval,
                         topk=arm_kw["topk"], data_path=tworld["fairface"])
    real = Adversary.from_cfg

    def jax_numbers(cfg, generator=None):
        adv = real(cfg, generator)
        adv.load_state_dict(adversary_params_from_jax(
            _tree_np(JAdversary.from_cfg(cfg).params)))
        return adv

    monkeypatch.setattr(Adversary, "from_cfg", staticmethod(jax_numbers))
    out = {}
    for name, w in (("adversarial", 1.0), ("control", 0.0)):
        out["jax", name] = J.run_arm(jworld, params, jcfg, jval, str(root / f"j{w}"),
                                     seed=seed, adversarial_weight=w, before=jb, **arm_kw)
        out["port", name] = T.run_arm(tworld, tparams, T.tiny_clip_cfg(), tval,
                                      str(root / f"t{w}"), seed=seed, adversarial_weight=w,
                                      before=tb, device="cpu", **arm_kw)
    return out


def _assert_arms_track_jax(out, atol):
    for name in ("adversarial", "control"):
        got, want = out["port", name], out["jax", name]
        print(f"{name}: JAX curve {[round(c['ndkl_eq_opp'], 4) for c in want['curve']]}, "
              f"drop {want['reduction']['ndkl_eq_opp']:.4f}; port curve "
              f"{[round(c['ndkl_eq_opp'], 4) for c in got['curve']]}, "
              f"drop {got['reduction']['ndkl_eq_opp']:.4f}")
        assert [c["step"] for c in got["curve"]] == [c["step"] for c in want["curve"]]
        np.testing.assert_allclose([c["ndkl_eq_opp"] for c in got["curve"]],
                                   [c["ndkl_eq_opp"] for c in want["curve"]], atol=atol)
        for part in ("before", "after"):
            for k, v in want[part].items():
                assert got[part][k] == pytest.approx(v, abs=atol), (name, part, k)


def test_arms_track_jax_from_one_tower(tmp_path, monkeypatch):
    """From JAX's tower and JAX's adversary init, both arms of the port's
    run_arm follow JAX's run_arm: every eval of the NDKL curve and the
    before / after metrics within 1e-4 (float32 rounding across two
    frameworks over 8 steps; the probe accuracy may flip at most a row)."""
    out = _arms_from_one_tower(tmp_path, 0, monkeypatch, n_train=128, n_val=64,
                               pretrain_steps=30, epochs=2, batch_size=32,
                               eval_every=1, topk=10)
    _assert_arms_track_jax(out, atol=1e-4)


@pytest.mark.slow
def test_arms_track_jax_from_one_tower_at_full_size(tmp_path, monkeypatch):
    """The same at the JAX module's defaults (seed 0: 2,500 pretraining
    steps, 3 epochs, 11 evals; minutes on the CPU).  ``-s`` prints both
    packages' curves."""
    out = _arms_from_one_tower(tmp_path, 0, monkeypatch, n_train=2048, n_val=512,
                               pretrain_steps=2500, topk=50)
    _assert_arms_track_jax(out, atol=1e-4)


@pytest.mark.slow
@pytest.mark.xfail(strict=False, reason=(
    "the port's seed-0 world fails the harness's probe precondition on the CPU "
    "(probe 0.8067 < 0.85): its pretraining draws torch generators, not "
    "jax.random, and the trajectory is chaotic across float configurations "
    "(tests/test_efficacy.py's docstring); JAX's own arms from JAX's seed-0 "
    "tower in this suite's configuration drop NDKL by 13.7% / 7.5%, not the "
    "record's 86.8% / 18.9%"))
def test_full_seed0_ablation_meets_the_jax_bars(tmp_path):
    """tests/test_efficacy.py's bars on the port's seed-0 ablation at the
    JAX module's defaults, on the CPU (minutes).  Expected to fail for the
    reason in its mark; it stays runnable so that the bars can be read
    against a later world or float configuration."""
    res = T.run_ablation_experiment(str(tmp_path), seeds=(0,), device="cpu")
    assert res["invalid"] == {}, res["invalid"]
    adv, ctl = res["seeds"][0]["adversarial"], res["seeds"][0]["control"]
    before, after = adv["before"], adv["after"]
    assert adv["before"] == ctl["before"]
    assert after["ndkl_eq_opp"] < 0.6 * before["ndkl_eq_opp"]
    assert after["maxskew@50_eq_opp"] < before["maxskew@50_eq_opp"]
    assert after["probe_acc"] >= before["probe_acc"] - 0.15
    curve = [c["ndkl_eq_opp"] for c in adv["curve"]]
    assert len(curve) >= 3 and min(curve) < 0.9 * curve[0]
    adv_drop = adv["reduction"]["ndkl_eq_opp"]
    ctl_drop = ctl["reduction"]["ndkl_eq_opp"]
    assert adv_drop >= 0.40 and adv_drop - ctl_drop >= 0.25
    assert adv["after"]["ndkl_eq_opp"] < 0.75 * ctl["after"]["ndkl_eq_opp"]
