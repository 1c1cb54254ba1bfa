"""The PyTorch port's adversarial training (debias_vision_lang_torch/train/,
models/adversary.py, the freezing policy in models/debias.py) against the
JAX package's.

Tiny towers (1 layer each, width 32, 2 heads, 16 px images, 16-token text),
inputs from numpy seeds, JAX weights brought across by
``models/convert.py``.  Bars: losses 1e-6; schedules, clipping and Adam
updates 1e-6; three trainer steps of every step variant at float32:
tokens, adversary parameters and every loss within 1e-5 (trained CLIP
parameters too, where Adam allows it: an element whose gradient is at
Adam's eps (1e-8) steps by however rounding falls, so at most 1 in 1,000
elements may differ by more than 1e-5 and none by more than 3 x lr; the
key slice of ``bqkv`` has a zero gradient in exact arithmetic -- a softmax
row is shift-invariant -- so there both frameworks step on rounding noise,
and it is held to 3 x lr of its start).  bfloat16 and int8
compute as the JAX package's own tests hold them (tests/test_train.py).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from debias_vision_lang_tpu.core.config import (AdversaryConfig, CLIPConfig,
                                                DebiasConfig, TextConfig,
                                                TrainConfig, VisionConfig)
from debias_vision_lang_torch.models.adversary import Adversary
from debias_vision_lang_torch.models.clip import CLIP
from debias_vision_lang_torch.models.convert import adversary_params_from_jax, params_from_jax
from debias_vision_lang_torch.models.debias import (DebiasCLIP, apply_grad_mask,
                                                    classify_params, layer_counts,
                                                    trainable_mask)
from debias_vision_lang_torch.train import adversarial as adv_t
from torch_port_config import port_config

torch.set_num_threads(1)

CTX, VOCAB, N_PROMPTS = 16, 128, 6
CFG = CLIPConfig(
    name="tiny",
    vision=VisionConfig(kind="vit", image_size=16, patch_size=8, width=32, layers=1,
                        heads=2, embed_dim=16),
    text=TextConfig(vocab_size=VOCAB, context_length=CTX, width=32, layers=1, heads=2,
                    embed_dim=16))
ACFG = AdversaryConfig(n_input=N_PROMPTS, hidden_size=8)


# The port is driven with its own config objects, built from the JAX
# package's ones field by field (port_config).
def _create(model, adv, tcfg, *args, **kw):
    return adv_t.AdversarialTrainer.create(model, adv, port_config(tcfg), *args, **kw)


def _build_train_steps(cfg, dcfg, acfg, tcfg, *args, **kw):
    return adv_t.build_train_steps(port_config(cfg), port_config(dcfg), port_config(acfg),
                                   port_config(tcfg), *args, **kw)


def _ids(rng, b):
    ids = np.zeros((b, CTX), np.int32)
    ids[:, 0] = VOCAB - 2
    ids[:, 1] = rng.integers(1, 100, b)
    ids[:, 2] = VOCAB - 1
    return ids


@pytest.fixture(scope="module")
def world():
    """numpy copies of JAX-initialised weights, tokens, adversary, prompts."""
    import jax

    from debias_vision_lang_tpu.models.adversary import init_adversary_params
    from debias_vision_lang_tpu.models.clip import init_clip_params

    params = jax.tree.map(np.array, init_clip_params(jax.random.key(0), CFG))
    tokens = np.random.default_rng(1).normal(size=(2, 32)).astype(np.float32) * 0.02
    aparams = jax.tree.map(np.array, init_adversary_params(jax.random.key(2), ACFG))
    sens = _ids(np.random.default_rng(0), N_PROMPTS)
    return params, tokens, aparams, sens


def _batch(seed, b=8):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(b, 16, 16, 3)).astype(np.float32)
    labels = (rng.random(b) < 0.5).astype(np.float32)
    cap_images = rng.normal(size=(b, 16, 16, 3)).astype(np.float32)
    return images, labels, cap_images, _ids(rng, b)


def adversary_to_jax(state_dict):
    """``Adversary`` state dict -> the JAX package's adversary params."""
    n = len({k.split(".")[1] for k in state_dict})
    return {"layers": [{k: state_dict[f"layers.{i}.{k}"].detach().numpy()
                        for k in ("kernel", "bias")} for i in range(n)]}


def _jax_model(world, dcfg):
    import jax
    import jax.numpy as jnp

    from debias_vision_lang_tpu.models.debias import DebiasCLIP as JDebiasCLIP

    params, tokens, _, _ = world
    return JDebiasCLIP(clip_params=jax.tree.map(jnp.asarray, params),
                       debias_tokens=jnp.asarray(tokens), clip_cfg=CFG, debias_cfg=dcfg)


def _jax_adversary(world):
    import jax
    import jax.numpy as jnp

    from debias_vision_lang_tpu.models.adversary import Adversary as JAdversary

    return JAdversary(params=jax.tree.map(jnp.asarray, world[2]), cfg=ACFG)


def _port_model(world, dcfg):
    params, tokens, _, _ = world
    clip = CLIP(port_config(CFG))
    clip.load_state_dict(params_from_jax(params, port_config(CFG)))
    return DebiasCLIP(clip, torch.from_numpy(tokens.copy()), port_config(dcfg))


def _port_adversary(world):
    adv = Adversary(port_config(ACFG))
    adv.load_state_dict(adversary_params_from_jax(world[2]))
    return adv


# ---------------------------------------------------------------------------
# Freezing policy
# ---------------------------------------------------------------------------


def _jax_mask_by_name(mask):
    """JAX mask pytree -> {port parameter name: multiplier}; a stacked
    resblock leaf's per-layer slice becomes one entry per layer."""
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(mask)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        leaf = np.asarray(leaf)
        tower, sep, rest = name.partition(".resblocks.")
        if sep:
            for i in range(leaf.shape[0]):
                out[f"{tower}.resblocks.{i}.{rest}"] = float(leaf[i].reshape(-1)[0])
        else:
            out[name] = float(leaf.reshape(-1)[0])
    return out


class TestFreezingPolicy:
    @pytest.fixture(scope="class")
    def deep(self):
        import jax

        from debias_vision_lang_tpu.models.clip import init_clip_params

        cfg = dataclasses.replace(
            CFG, vision=dataclasses.replace(CFG.vision, layers=3),
            text=dataclasses.replace(CFG.text, layers=2))
        params = jax.tree.map(np.array, init_clip_params(jax.random.key(0), cfg))
        clip = CLIP(port_config(cfg))
        clip.load_state_dict(params_from_jax(params, port_config(cfg)))
        return params, clip

    @pytest.mark.parametrize("n_text", [0, 1, 2])
    @pytest.mark.parametrize("n_vid", [0, 1, 3])
    @pytest.mark.parametrize("freeze_proj", [True, False])
    def test_mask_equals_jax(self, deep, n_text, n_vid, freeze_proj):
        from debias_vision_lang_tpu.models.debias import trainable_mask as jax_mask

        params, clip = deep
        dcfg = DebiasConfig(n_train_text_layers=n_text, n_train_vid_layers=n_vid,
                            freeze_proj=freeze_proj)
        got = trainable_mask(clip, port_config(dcfg))
        assert got == _jax_mask_by_name(jax_mask(params, dcfg))
        assert set(got) == {n for n, _ in clip.named_parameters()}

    @pytest.mark.parametrize("kw", [{"n_train_text_layers": 3}, {"n_train_vid_layers": 4},
                                    {"n_train_text_layers": -1}])
    def test_bad_counts_raise_as_jax(self, deep, kw):
        from debias_vision_lang_tpu.models.debias import trainable_mask as jax_mask

        params, clip = deep
        dcfg = DebiasConfig(**kw)
        with pytest.raises(ValueError) as want:
            jax_mask(params, dcfg)
        with pytest.raises(ValueError) as got:
            trainable_mask(clip, port_config(dcfg))
        assert str(got.value) == str(want.value)

    def test_classify_and_counts(self, deep):
        _, clip = deep
        meta, classed = classify_params(clip)
        assert layer_counts(clip) == {"image": 3, "text": 2}
        assert meta["image"] == 3 and meta["text"] == 2
        assert meta["proj"] == 7  # ln_final x2, text_projection, logit_scale, ln_post x2, proj
        assert meta["tokens"] == 1
        kinds = {c["name"]: c["type"] for c in classed}
        assert kinds["visual.resblocks.2.mlp.w1"] == "image"
        assert kinds["visual.conv1.kernel"] == "other"

    def test_apply_grad_mask(self, deep):
        _, clip = deep
        mask = trainable_mask(clip, port_config(DebiasConfig(n_train_text_layers=1)))
        grads = {n: torch.ones_like(p) for n, p in clip.named_parameters()}
        out = apply_grad_mask(grads, mask)
        assert float(out["text.resblocks.1.attn.wo"].sum()) == 32 * 32
        assert float(out["text.resblocks.0.attn.wo"].abs().sum()) == 0
        assert float(out["logit_scale"]) == 0

    def test_model_method(self, world):
        model = _port_model(world, DebiasConfig(freeze_proj=False))
        assert model.trainable_mask()["logit_scale"] == 1.0


# ---------------------------------------------------------------------------
# Adversary
# ---------------------------------------------------------------------------


class TestAdversary:
    def test_forward_equals_jax(self, world):
        import jax.numpy as jnp

        from debias_vision_lang_tpu.models.adversary import apply, apply_logits

        adv = _port_adversary(world)
        x = np.random.default_rng(3).normal(size=(5, N_PROMPTS)).astype(np.float32)
        with torch.no_grad():
            np.testing.assert_allclose(adv.apply_logits(torch.from_numpy(x)).numpy(),
                                       np.asarray(apply_logits(world[2], jnp.asarray(x))),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(adv.apply(torch.from_numpy(x)).numpy(),
                                       np.asarray(apply(world[2], jnp.asarray(x))),
                                       rtol=1e-6, atol=1e-6)
        back = adversary_to_jax(adv.state_dict())
        for a, b in zip(back["layers"], world[2]["layers"]):
            np.testing.assert_array_equal(a["kernel"], b["kernel"])

    def test_init_is_torch_linear_uniform(self):
        adv = Adversary.from_cfg({"ADV_N_INPUT": 319, "ADV_HIDDEN_SIZE": 32, "SEED": 3})
        sizes = [319, 32, 32, 32, 1]
        assert [tuple(l.kernel.shape) for l in adv.layers] == list(zip(sizes[:-1], sizes[1:]))
        for layer in adv.layers:
            bound = layer.kernel.shape[0] ** -0.5
            for p in (layer.kernel, layer.bias):
                assert float(p.detach().abs().max()) <= bound
        assert float(adv.layers[0].kernel.detach().abs().max()) > 0.9 * 319 ** -0.5
        again = Adversary.from_cfg({"ADV_N_INPUT": 319, "ADV_HIDDEN_SIZE": 32, "SEED": 3})
        assert torch.equal(adv.layers[0].kernel, again.layers[0].kernel)
        other = Adversary.from_cfg({"ADV_N_INPUT": 319, "ADV_HIDDEN_SIZE": 32, "SEED": 4})
        assert not torch.equal(adv.layers[0].kernel, other.layers[0].kernel)


# ---------------------------------------------------------------------------
# Losses, schedules, clipping, Adam
# ---------------------------------------------------------------------------


class TestLosses:
    def test_losses_equal_jax(self):
        import jax.numpy as jnp

        from debias_vision_lang_tpu.train import adversarial as J

        rng = np.random.default_rng(4)
        logits = rng.normal(size=(8, 1)).astype(np.float32) * 3
        labels = (rng.random(8) < 0.5).astype(np.float32)
        logits3 = rng.normal(size=(8, 3)).astype(np.float32)
        labels3 = rng.integers(0, 3, 8).astype(np.float32)
        img = rng.normal(size=(8, 16)).astype(np.float32)
        txt = rng.normal(size=(8, 16)).astype(np.float32)
        ls = np.float32(math.log(1 / 0.07))
        t = torch.from_numpy
        pairs = [
            (adv_t.sigmoid_bce(t(logits[:, 0]), t(labels)),
             J.sigmoid_bce(jnp.asarray(logits[:, 0]), jnp.asarray(labels))),
            (adv_t.adversary_loss(t(logits), t(labels), 1),
             J.adversary_loss(jnp.asarray(logits), jnp.asarray(labels), 1)),
            (adv_t.adversary_loss(t(logits3), t(labels3), 3),
             J.adversary_loss(jnp.asarray(logits3), jnp.asarray(labels3), 3)),
            (adv_t.clip_contrastive_loss(t(img), t(txt), torch.tensor(ls)),
             J.clip_contrastive_loss(jnp.asarray(img), jnp.asarray(txt), jnp.asarray(ls))),
        ]
        for got, want in pairs:
            assert abs(float(got) - float(want)) <= 1e-6 * max(1.0, abs(float(want)))
        np.testing.assert_allclose(
            adv_t.similarity_scores(t(img), t(txt), torch.tensor(ls)).numpy(),
            np.asarray(J.similarity_scores(jnp.asarray(img), jnp.asarray(txt),
                                           jnp.asarray(ls))), rtol=1e-6, atol=1e-5)


SCHEDULES = [
    TrainConfig(),
    TrainConfig(lr_schedule="cosine", decay_steps=7),
    TrainConfig(lr_schedule="warmup_cosine", warmup_steps=3, decay_steps=9),
    TrainConfig(lr_schedule="warmup_cosine", warmup_steps=0, decay_steps=5),
]


class TestOptimizer:
    @pytest.mark.parametrize("tcfg", SCHEDULES, ids=lambda c: f"{c.lr_schedule}-{c.warmup_steps}")
    def test_schedule_is_optax(self, tcfg):
        import optax

        from debias_vision_lang_tpu.train.adversarial import make_optimizer as jax_opt

        sched = adv_t.lr_schedule(2e-3, port_config(tcfg))
        peak = 2e-3
        if tcfg.lr_schedule == "constant":
            want = lambda n: peak  # noqa: E731
        elif tcfg.lr_schedule == "cosine":
            want = optax.cosine_decay_schedule(peak, tcfg.decay_steps)
        else:
            want = optax.warmup_cosine_decay_schedule(0.0, peak, tcfg.warmup_steps,
                                                      tcfg.decay_steps)
        jax_opt(peak, tcfg)  # the JAX function accepts the same config
        for n in range(12):
            assert abs(sched(n) - float(want(n))) <= 1e-6 * peak, n

    @pytest.mark.parametrize("kw,match", [
        ({"lr_schedule": "cosine"}, "decay_steps"),
        ({"lr_schedule": "cosine", "decay_steps": 5, "warmup_steps": 1}, "warmup_cosine"),
        ({"lr_schedule": "warmup_cosine", "decay_steps": 5, "warmup_steps": 5}, "must be <"),
        ({"lr_schedule": "linear"}, "unknown lr_schedule")])
    def test_bad_schedules_raise(self, kw, match):
        from debias_vision_lang_tpu.train.adversarial import make_optimizer as jax_opt

        with pytest.raises(ValueError, match=match):
            jax_opt(1e-3, TrainConfig(**kw))
        with pytest.raises(ValueError, match=match):
            adv_t.make_optimizer(1e-3, port_config(TrainConfig(**kw)), [])

    @pytest.mark.parametrize("max_norm", [0.5, 100.0])
    def test_clip_is_optax(self, max_norm):
        import jax.numpy as jnp
        import optax

        rng = np.random.default_rng(5)
        grads = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], None)
        got = adv_t.clip_by_global_norm([torch.from_numpy(g) for g in grads], max_norm)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
        if max_norm > 10:  # below the bar: unchanged
            for a, g in zip(got, grads):
                np.testing.assert_array_equal(a.numpy(), g)

    @pytest.mark.parametrize("tcfg", [
        TrainConfig(),
        TrainConfig(lr_schedule="warmup_cosine", warmup_steps=2, decay_steps=6,
                    grad_clip_norm=0.5)], ids=["adam", "warmup_cosine+clip"])
    def test_updates_are_optax(self, tcfg):
        import jax.numpy as jnp
        import optax

        from debias_vision_lang_tpu.train.adversarial import make_optimizer as jax_opt

        rng = np.random.default_rng(6)
        p0 = [rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=(3,)).astype(np.float32)]
        tx = jax_opt(1e-2, tcfg)
        jp = [jnp.asarray(p) for p in p0]
        state = tx.init(jp)
        tp = [torch.from_numpy(p.copy()).requires_grad_(True) for p in p0]
        opt = adv_t.make_optimizer(1e-2, port_config(tcfg), tp)
        for _ in range(5):
            grads = [rng.normal(size=p.shape).astype(np.float32) for p in p0]
            upd, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
            jp = optax.apply_updates(jp, upd)
            opt.step([torch.from_numpy(g) for g in grads])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
        assert opt.count == 5


# ---------------------------------------------------------------------------
# The trainer against JAX's, three float32 steps
# ---------------------------------------------------------------------------

VARIANTS = {
    "frozen": ({}, 1, False),
    "frozen-cadence0": ({}, 0, False),
    "frozen-cadence2": ({}, 2, False),
    "text_layers": ({"n_train_text_layers": 1}, 1, False),
    "with_layers": ({"n_train_vid_layers": 1, "freeze_proj": False}, 1, False),
    "approx_scores": ({"n_train_vid_layers": 1}, 1, True),
    "from_embeddings": ({}, 1, False),
}


def _close(got, want, what, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), f"{what}: max err {err}"


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_trainer_matches_jax(world, variant):
    import jax

    from debias_vision_lang_tpu.train.adversarial import AdversarialTrainer as JTrainer
    from debias_vision_lang_torch.train.adversarial import AdversarialTrainer

    dkw, cadence, approx = VARIANTS[variant]
    dcfg = DebiasConfig(num_debias_tokens=2, hidden_dim=32, max_tokens=CTX, **dkw)
    tcfg = TrainConfig(adversary_steps_per_prompt_step=cadence,
                       approx_frozen_scores=approx)
    sens = world[3]
    jt = JTrainer.create(_jax_model(world, dcfg), _jax_adversary(world), tcfg, sens,
                         use_pallas=False)
    model, adv = _port_model(world, dcfg), _port_adversary(world)
    pt = AdversarialTrainer.create(model, adv, port_config(tcfg), sens)
    assert (jt.grad_mask is None) == (pt.grad_mask is None)
    assert jt.trains_image == pt.trains_image
    rng = np.random.default_rng(11)
    for i in range(3):
        images, labels, cap_images, cap_tokens = _batch(20 + i)
        if variant == "from_embeddings":
            img_e = rng.normal(size=(8, 16)).astype(np.float32)
            cap_e = rng.normal(size=(8, 16)).astype(np.float32)
            jm = jt.step_from_embeddings(img_e, labels, cap_e, cap_tokens)
            pm = pt.step_from_embeddings(img_e, labels, cap_e, cap_tokens)
        else:
            jm = jt.step(images, labels, cap_images, cap_tokens)
            pm = pt.step(images, labels, cap_images, cap_tokens)
        assert set(jm) == set(pm) and pm["step"] == i + 1
        for k in ("loss", "adv_loss", "contrastive_loss"):
            _close(pm[k], jm[k], f"step {i + 1} {k}")
        if cadence == 0:
            assert math.isnan(pm["adversary_bce"]) and math.isnan(jm["adversary_bce"])
        else:
            _close(pm["adversary_bce"], jm["adversary_bce"], f"step {i + 1} adversary_bce")
    start = world[1]
    tokens = model.debias_tokens.detach().numpy()
    _close(tokens, np.asarray(jt.model.debias_tokens), "tokens")
    assert np.abs(tokens - start).max() > 1e-3  # they moved
    back = adversary_to_jax(adv.state_dict())
    for a, b in zip(back["layers"], jt.adversary_params["layers"]):
        for k in ("kernel", "bias"):
            _close(a[k], np.asarray(b[k]), f"adversary {k}")
    if cadence == 0:
        np.testing.assert_array_equal(back["layers"][0]["kernel"], world[2]["layers"][0]["kernel"])
    if pt.grad_mask is not None:
        want = params_from_jax(jax.tree.map(np.asarray, jt.model.clip_params), CFG)
        init = params_from_jax(world[0], CFG)
        lr = tcfg.prompt_lr
        for name, t in model.clip.state_dict().items():
            got, w = t.numpy(), want[name].numpy()
            if name.endswith("attn.bqkv"):  # the key slice: see the module docstring
                d = got.shape[0] // 3
                assert np.abs(got[d: 2 * d] - init[name].numpy()[d: 2 * d]).max() <= 3 * lr
                got, w = np.concatenate([got[:d], got[2 * d:]]), np.concatenate([w[:d], w[2 * d:]])
            err = np.abs(got - w)
            # an element whose gradient sits at Adam's eps (1e-8) steps by
            # however rounding falls: rare, and bounded by the step size
            assert (err > 1e-5).mean() <= 1e-3 and err.max() <= 3 * lr, name
            if pt.grad_mask[name] == 0:
                np.testing.assert_array_equal(t.numpy(), init[name].numpy())


class TestTrainerSurface:
    def test_step_from_embeddings_refuses_image_training(self, world):
        dcfg = DebiasConfig(num_debias_tokens=2, hidden_dim=32, n_train_vid_layers=1)
        tr = _create(_port_model(world, dcfg), _port_adversary(world),
                                             TrainConfig(), world[3])
        with pytest.raises(ValueError, match="frozen image path"):
            tr.step_from_embeddings(np.zeros((8, 16)), np.zeros(8), np.zeros((8, 16)),
                                    _ids(np.random.default_rng(0), 8))

    def test_negative_cadence_raises(self, world):
        tr = _create(
            _port_model(world, DebiasConfig(hidden_dim=32)), _port_adversary(world),
            TrainConfig(adversary_steps_per_prompt_step=-1), world[3])
        with pytest.raises(ValueError, match=">= 0"):
            tr.step(*_batch(1))

    def test_mesh_raises(self, world):
        with pytest.raises(NotImplementedError, match="queue 1 item 5"):
            _create(
                _port_model(world, DebiasConfig(hidden_dim=32)), _port_adversary(world),
                TrainConfig(), world[3], mesh="auto")

    def test_freezing_sets_requires_grad(self, world):
        model = _port_model(world, DebiasConfig(hidden_dim=32, n_train_text_layers=1))
        _create(model, _port_adversary(world), TrainConfig(), world[3])
        grad = {n for n, p in model.clip.named_parameters() if p.requires_grad}
        assert grad == {n for n, _ in model.clip.named_parameters()
                        if n.startswith("text.resblocks.0.")}
        assert model.debias_tokens.requires_grad

    def test_maybe_update_best_snapshots_layers(self, world):
        model = _port_model(world, DebiasConfig(hidden_dim=32, n_train_text_layers=1))
        tr = _create(model, _port_adversary(world), TrainConfig(),
                                             world[3])
        assert tr.maybe_update_best(0.5) and not tr.maybe_update_best(0.7)
        before = tr.best_clip_params["text.resblocks.0.attn.wo"].clone()
        tr.step(*_batch(2))
        assert torch.equal(tr.best_clip_params["text.resblocks.0.attn.wo"], before)
        assert not torch.equal(model.clip.text.resblocks[0].attn.wo.detach(), before)
        np.testing.assert_array_equal(tr.best_tokens, world[1])


# ---------------------------------------------------------------------------
# embed_dtype / train_dtype
# ---------------------------------------------------------------------------


def _cos_rows(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


class TestDtypes:
    def test_bf16_embed_close_to_fp32(self, world):
        dcfg = DebiasConfig(hidden_dim=32)
        model = _port_model(world, dcfg)
        images = torch.from_numpy(_batch(5)[0])
        fns32 = _build_train_steps(CFG, dcfg, ACFG, TrainConfig(), world[3])
        fns16 = _build_train_steps(CFG, dcfg, ACFG,
                                        TrainConfig(embed_dtype="bfloat16"), world[3])
        e32, e16 = fns32.embed_images(model, images), fns16.embed_images(model, images)
        assert e16.dtype == torch.float32
        assert _cos_rows(e16, e32).min() > 0.99

    def test_bf16_train_dtype(self, world):
        """Mixed precision through the differentiable fused blocks: the loss
        near float32, the update correlated with it, state float32."""
        batch = _batch(7)
        results = {}
        for td in ("float32", "bfloat16"):
            model = _port_model(world, DebiasConfig(hidden_dim=32))
            tr = _create(model, _port_adversary(world),
                                                 TrainConfig(train_dtype=td), world[3])
            m = tr.step(*batch)
            after = model.debias_tokens.detach()
            assert after.dtype == torch.float32
            results[td] = (m["loss"], after.numpy() - world[1])
        (l32, u32), (l16, u16) = results["float32"], results["bfloat16"]
        assert np.isfinite(l16) and abs(l16 - l32) < 0.2 * (abs(l32) + 1e-6)
        assert _cos_rows(u16.ravel(), u32.ravel()) > 0.5

    def test_bf16_token_gradient_reaches_the_prompt_array(self, world):
        dcfg = DebiasConfig(hidden_dim=32)
        model = _port_model(world, dcfg)
        model.clip.requires_grad_(False)
        ids = torch.from_numpy(_ids(np.random.default_rng(3), 4)).long()
        g = {}
        for dt in (torch.float32, torch.bfloat16):
            model.debias_tokens.grad = None
            model.encode_text(ids, dtype=dt).float().square().sum().backward()
            g[dt] = model.debias_tokens.grad.clone()
        assert g[torch.bfloat16].abs().max() > 0
        assert _cos_rows(g[torch.bfloat16].ravel(), g[torch.float32].ravel()) > 0.99

    def test_int8_embed_dtype(self, world):
        dcfg = DebiasConfig(hidden_dim=32)
        model = _port_model(world, dcfg)
        images, labels, cap_images, cap_tokens = _batch(8)
        t8 = _create(model, _port_adversary(world),
                                             TrainConfig(embed_dtype="int8"), world[3])
        fns32 = _build_train_steps(CFG, dcfg, ACFG, TrainConfig(), world[3])
        x = torch.from_numpy(images)
        e8, e32 = t8.fns.embed_images(model, x), fns32.embed_images(model, x)
        assert _cos_rows(e8, e32).min() > 0.97
        m = t8.step(images, labels, cap_images, cap_tokens)
        assert np.isfinite(m["loss"]) and np.isfinite(m["adversary_bce"])

    def test_int8_never_embeds_stale_weights(self, world):
        """Image-path training changes the visual weights every step; the
        int8 embed re-quantizes from them (JAX re-quantizes per call)."""
        from debias_vision_lang_torch.ops.quant import QuantizedCLIP

        dcfg = DebiasConfig(hidden_dim=32, n_train_vid_layers=1)
        model = _port_model(world, dcfg)
        tr = _create(model, _port_adversary(world),
                                             TrainConfig(embed_dtype="int8"), world[3])
        x = torch.from_numpy(_batch(9)[0])
        before = tr.fns.embed_images(model, x)
        tr.step(*_batch(10))
        after = tr.fns.embed_images(model, x)
        with torch.no_grad():
            fresh = QuantizedCLIP(model).encode_image(x).float()
        torch.testing.assert_close(after, fresh, rtol=0, atol=0)
        assert not torch.equal(after, before)

    def test_bad_dtype_raises(self, world):
        with pytest.raises(ValueError, match="train_dtype"):
            _build_train_steps(CFG, DebiasConfig(), ACFG,
                                    TrainConfig(train_dtype="float16"), world[3])


# ---------------------------------------------------------------------------
# State: checkpoints, resume, export
# ---------------------------------------------------------------------------


class TestState:
    def _trainer(self, world, **dkw):
        dcfg = DebiasConfig(num_debias_tokens=2, hidden_dim=32, **dkw)
        return _create(
            _port_model(world, dcfg), _port_adversary(world),
            TrainConfig(lr_schedule="warmup_cosine", warmup_steps=1, decay_steps=10,
                        grad_clip_norm=1.0), world[3])

    @pytest.mark.parametrize("dkw", [{}, {"n_train_text_layers": 1}], ids=["frozen", "layers"])
    def test_resume_continues_the_same_trajectory(self, world, tmp_path, dkw):
        from debias_vision_lang_torch.train.state import (latest_checkpoint,
                                                          restore_checkpoint,
                                                          save_checkpoint)

        a = self._trainer(world, **dkw)
        a.step(*_batch(30))
        a.step(*_batch(31))
        a.maybe_update_best(0.25)
        save_checkpoint(str(tmp_path), a)
        a.step(*_batch(32))

        b = self._trainer(world, **dkw)
        path = latest_checkpoint(str(tmp_path))
        assert path.endswith("step_2.pt")
        restore_checkpoint(path, b)
        assert b.step_count == 2 and b.best_ndkl == 0.25
        assert b.prompt_opt.count == a.prompt_opt.count - 1
        np.testing.assert_array_equal(b.best_tokens, a.best_tokens)
        b.step(*_batch(32))
        torch.testing.assert_close(b.model.debias_tokens, a.model.debias_tokens,
                                   rtol=0, atol=0)
        for x, y in zip(b.adversary.parameters(), a.adversary.parameters()):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        if dkw:
            assert b.best_clip_params is not None
            torch.testing.assert_close(b.model.clip.text.resblocks[0].attn.wo,
                                       a.model.clip.text.resblocks[0].attn.wo, rtol=0, atol=0)

    def test_mismatched_trainer_raises(self, world, tmp_path):
        from debias_vision_lang_torch.train.state import restore_checkpoint, save_checkpoint

        path = save_checkpoint(str(tmp_path), self._trainer(world))
        with pytest.raises(ValueError, match="state mismatch"):
            restore_checkpoint(path, self._trainer(world, n_train_text_layers=1))

    def test_latest_checkpoint(self, tmp_path):
        from debias_vision_lang_torch.train.state import latest_checkpoint

        assert latest_checkpoint(str(tmp_path / "absent")) is None
        for n in ("step_3.pt", "step_12.pt", "step_x.pt", "other.pt"):
            (tmp_path / n).write_bytes(b"")
        assert latest_checkpoint(str(tmp_path)).endswith("step_12.pt")

    def test_export_equals_jax_export(self, world, tmp_path):
        from debias_vision_lang_tpu.models.convert import (load_debias_prompt_pt,
                                                           save_debias_prompt_pt)
        from debias_vision_lang_torch.train.state import export_reference_pt

        tr = self._trainer(world)
        tr.step(*_batch(40))
        got = export_reference_pt(tr, str(tmp_path / "port.pt"))
        save_debias_prompt_pt(tr.model.debias_tokens.detach().numpy(), str(tmp_path / "jax.pt"))
        t = torch.load(got, map_location="cpu", weights_only=True)
        want = torch.load(str(tmp_path / "jax.pt"), map_location="cpu", weights_only=True)
        assert type(t) is torch.Tensor and t.dtype == torch.float32 and t.is_contiguous()
        assert t.device.type == "cpu" and not t.requires_grad
        torch.testing.assert_close(t, want, rtol=0, atol=0)
        np.testing.assert_array_equal(load_debias_prompt_pt(got), want.numpy())
        tr.maybe_update_best(0.1)
        tr.step(*_batch(41))
        best = torch.load(export_reference_pt(tr, str(tmp_path / "best.pt")),
                          weights_only=True)
        np.testing.assert_array_equal(best.numpy(), tr.best_tokens)
