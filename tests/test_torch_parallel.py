"""The port's distribution (debias_vision_lang_torch/parallel/) on the CPU.

The mesh against JAX's (tests/test_parallel.py's cases), the data-parallel
embed against JAX's ``dp_shard_map`` embed on its 8 virtual CPU devices
(float32, atol 1e-4, the float32 parity bar of tests/test_torch_models.py),
and every entry point that takes a ``mesh`` against the port's own
unsharded call on a CPU mesh of 8 slots: measure_bias (with and without
sharded metrics), zero-shot, the serving engine and the trainer.  Then
``init_distributed`` (a no-op without a coordinator, idempotent, the
arguments and the torchrun environment forwarded), and one two-rank gloo
world (``file://`` rendezvous): measure_bias(mesh="auto",
sharded_metrics=True) and a frozen trainer step equal on both ranks and to
one process; then trainers whose image-path parameters train
(``n_train_vid_layers=1``, ``freeze_proj=False``) for 3 steps: after every
step the ranks' parameters, tokens and optimizer state bit-equal, the first
gradient and update within 1e-5 of the largest magnitude of the
one-process 8-slot mesh's on the same global batch.  The differentiable
cross-rank gather's backward is held to ``torch.cat``'s in one process.

Run as a script, this file is one rank of that world (it imports no jax).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from debias_vision_lang_torch.core.config import (CLIPConfig, DebiasConfig, TextConfig,
                                                  TrainConfig, VisionConfig)
from debias_vision_lang_torch.models.clip import CLIP, init_clip_params
from debias_vision_lang_torch.models.debias import DebiasCLIP
from debias_vision_lang_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = [torch.device("cpu")] * 8
CTX, VOCAB, PX = 16, 128, 32
PROMPTS = ["a good person", "a bad person", "a photo of a doctor", "a criminal"]


def tiny_model(seed=0, **dkw) -> DebiasCLIP:
    cfg = CLIPConfig(
        name="tiny-mesh",
        vision=VisionConfig(kind="vit", image_size=PX, patch_size=8, width=32, layers=2,
                            heads=2, embed_dim=16),
        text=TextConfig(vocab_size=VOCAB, context_length=CTX, width=32, layers=1, heads=2,
                        embed_dim=16))
    clip = CLIP(cfg)
    clip.load_state_dict(init_clip_params(cfg, torch.Generator().manual_seed(seed)))
    tokens = torch.randn(2, 32, generator=torch.Generator().manual_seed(seed + 1)) * 0.02
    return DebiasCLIP(clip, tokens, DebiasConfig(num_debias_tokens=2, hidden_dim=32,
                                                 max_tokens=CTX, **dkw))


def tok(texts):
    out = np.zeros((len(texts), CTX), np.int64)
    out[:, 0] = VOCAB - 2
    for i, t in enumerate(texts):
        out[i, 1] = sum(t.encode()) % 100 + 1
        out[i, 2] = VOCAB - 1
    return out


def write_fairface(root, n=21, seed=0):
    """n val rows (ragged against every mesh here), balanced gender."""
    img_dir = os.path.join(root, "imgs", "train_val", "x")
    os.makedirs(img_dir)
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (PX + 8, PX, 3), dtype=np.uint8)).save(
            os.path.join(img_dir, f"{i}.png"))
        rows.append({"file": f"x/{i}.png", "age": "20-29",
                     "gender": "Male" if i % 2 else "Female", "race": "White"})
    for mode in ("train", "val"):
        d = os.path.join(root, "labels", mode)
        os.makedirs(d)
        pd.DataFrame(rows).to_csv(os.path.join(d, f"{mode}_labels.csv"), index=False)
    return root


def measure(model, ff_root, **opts):
    from debias_vision_lang_torch.eval.measure import measure_bias
    from debias_vision_lang_torch.vision.preprocess import Preprocess

    return measure_bias(model, Preprocess(PX), tok, "gender",
                        opts={"data_path": ff_root, "batch_size": 6, "num_workers": 1,
                              "topn": 0.5, "prompts": PROMPTS, **opts})


def trainer_batch(seed=3, b=16):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(b, PX, PX, 3)).astype(np.float32)
    cap_images = rng.normal(size=(b, PX, PX, 3)).astype(np.float32)
    labels = (np.arange(b) % 2).astype(np.float32)
    return images, labels, cap_images, tok([f"caption {i}" for i in range(b)])


def make_trainer(mesh, model=None, **tkw):
    from debias_vision_lang_torch.models.adversary import Adversary
    from debias_vision_lang_torch.train.adversarial import AdversarialTrainer

    adv = Adversary.from_cfg({"ADV_N_INPUT": 2, "ADV_N_OUTPUT": 1, "ADV_HIDDEN_SIZE": 8,
                              "SEED": 0})
    return AdversarialTrainer.create(
        model if model is not None else tiny_model(), adv,
        TrainConfig(batch_size=16, num_epochs=1, **tkw),
        tok(["a good person", "a bad person"]), use_pallas=False, mesh=mesh)


def run_steps(trainer, n=2):
    batch = trainer_batch()
    metrics = [trainer.step(*batch) for _ in range(n)]
    return metrics, trainer.model.debias_tokens.detach().clone()


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


class TestMesh:
    def test_eight_slots_like_jax(self):
        from debias_vision_lang_tpu.parallel.mesh import create_mesh as jcreate

        jm, tm = jcreate(), pmesh.create_mesh(devices=CPU8)
        assert tm.devices.size == jm.devices.size == 8
        assert tm.axis_names == jm.axis_names == ("data", "model")
        assert dict(tm.shape) == dict(jm.shape) == {"data": 8, "model": 1}

    def test_2d_shape(self):
        assert pmesh.create_mesh((4, 2), devices=CPU8).devices.shape == (4, 2)

    def test_bad_shape_raises(self):
        with pytest.raises(ValueError, match=r"mesh shape \(3, 2\) != 8 devices"):
            pmesh.create_mesh((3, 2), devices=CPU8)

    def test_default_without_a_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.create_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.default_mesh("cuda")

    def test_default_mesh_follows_the_device_type(self):
        m = pmesh.default_mesh("cpu")
        assert dict(m.shape) == {"data": 1, "model": 1} and m.world == 1
        assert m.first_device == torch.device("cpu")

    def test_model_axis_row_owner_computes_each_shard(self):
        m = pmesh.create_mesh((4, 2), devices=CPU8)
        assert [i for i, _ in m.data_shards()] == [0, 1, 2, 3]
        assert [i for i, _ in m.data_shards("model")] == [0, 1]


class TestShardingHelpers:
    def test_shard_batch_arrays_splits_in_order(self):
        mesh = pmesh.create_mesh(devices=CPU8)
        a = np.arange(16 * 3).reshape(16, 3)
        s = pmesh.shard_batch_arrays(mesh, a)
        assert s.shape == (16, 3) and [i for i, _ in s.shards] == list(range(8))
        np.testing.assert_array_equal(torch.cat([t for _, t in s.shards]).numpy(), a)

    def test_indivisible_batch_raises(self):
        with pytest.raises(ValueError, match="does not divide"):
            pmesh.shard_batch_arrays(pmesh.create_mesh(devices=CPU8), np.zeros((10, 2)))

    def test_shard_batch_of_a_loader_batch(self):
        from debias_vision_lang_torch.data.loader import Batch, shard_batch

        b = Batch(np.zeros((8, 4, 4, 3), np.uint8), np.arange(8, dtype=np.int32), 8)
        images, labels = shard_batch(b, pmesh.create_mesh(devices=CPU8))
        assert len(images.shards) == len(labels.shards) == 8
        assert [int(t) for _, t in labels.shards] == list(range(8))
        x, y = shard_batch(b, device="cpu")
        assert x.shape == (8, 4, 4, 3) and y.tolist() == list(range(8))

    def test_slots_sharing_a_device_share_the_replica(self):
        model = tiny_model()
        rep = pmesh.replicate_params(model, pmesh.create_mesh(devices=CPU8))
        assert rep.copies == {torch.device("cpu"): model}
        assert pmesh.replicate_params(rep, None) is rep

    def test_gather_across_ranks_backward_is_torch_cat_s(self, monkeypatch):
        """The world's gather as rank 1 of 2 sees it (the collective stood in
        for by the other rank's fixed rows): forward = torch.cat in rank
        order, backward = this rank's rows of the upstream gradient."""
        mesh = pmesh.create_mesh(devices=[torch.device("cpu")] * 2)
        mesh.world = 2
        other = torch.randn(4, 3, generator=torch.Generator().manual_seed(1))
        monkeypatch.setattr(pmesh, "all_gather", lambda t: [other, t.detach().clone()])
        monkeypatch.setattr(pmesh, "_world", lambda: (2, 1))
        x = torch.randn(4, 3, generator=torch.Generator().manual_seed(2), requires_grad=True)
        w = torch.randn(8, 3, generator=torch.Generator().manual_seed(3))
        out = pmesh.gather_shards(mesh, [x[:2] * 2, x[2:] * 2])
        torch.testing.assert_close(out, torch.cat([other, x * 2]), rtol=0, atol=0)
        (g,) = torch.autograd.grad((out * w).sum(), x)
        y = x.detach().clone().requires_grad_(True)
        (want,) = torch.autograd.grad((torch.cat([other, y * 2]) * w).sum(), y)
        torch.testing.assert_close(g, want, rtol=0, atol=0)

    def test_gradients_flow_through_dp_shard_map(self):
        mesh = pmesh.create_mesh(devices=CPU8)
        w = torch.randn(3, 2, requires_grad=True)
        x = torch.randn(16, 3)
        out = pmesh.dp_shard_map(mesh, lambda p, xs: xs @ p)(w, x)
        (g,) = torch.autograd.grad(out.square().sum(), w)
        torch.testing.assert_close(g, torch.autograd.grad((x @ w).square().sum(), w)[0])

    def test_tuple_outputs_are_gathered_each(self):
        mesh = pmesh.create_mesh(devices=CPU8)
        x = torch.arange(16.0)[:, None]
        a, b = pmesh.dp_shard_map(mesh, lambda _, xs: (xs + 1, xs * 2))(None, x)
        torch.testing.assert_close(a, x + 1)
        torch.testing.assert_close(b, x * 2)


# ---------------------------------------------------------------------------
# The data-parallel embed against JAX's
# ---------------------------------------------------------------------------


class TestDPEmbedAgainstJax:
    def test_dp_embed_matches_jax(self, tiny_clip):
        import jax
        import jax.numpy as jnp

        from debias_vision_lang_torch.models.convert import params_from_jax
        from debias_vision_lang_tpu.models import clip as jclip
        from debias_vision_lang_tpu.parallel.mesh import (create_mesh as jcreate,
                                                          dp_shard_map as jdp,
                                                          replicate_params as jrep)
        from torch_port_config import port_config

        cfg, params = tiny_clip
        images = np.random.default_rng(0).normal(size=(16, 32, 32, 3)).astype(np.float32)
        jm = jcreate()
        want = np.asarray(jdp(jm, lambda p, x: jclip.encode_image(p, x, cfg, use_pallas=False))(
            jrep(params, jm), jax.device_put(jnp.asarray(images))))
        tcfg = port_config(cfg)
        model = CLIP(tcfg)
        model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tcfg))
        mesh = pmesh.create_mesh(devices=CPU8)
        with torch.no_grad():
            got = pmesh.dp_shard_map(mesh, lambda m, x: m.encode_image(x))(
                pmesh.replicate_params(model, mesh), images)
            single = model.encode_image(torch.from_numpy(images))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
        torch.testing.assert_close(got, single, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# The entry points under a mesh against the port without one
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ff_root(tmp_path_factory):
    return write_fairface(str(tmp_path_factory.mktemp("ff_mesh")))


class TestMeasureUnderMesh:
    def test_ragged_batches_embed_as_without_a_mesh(self, ff_root):
        from debias_vision_lang_torch.data.datasets import FairFace
        from debias_vision_lang_torch.data.loader import HostLoader
        from debias_vision_lang_torch.eval.measure import get_labels_img_embeddings

        ds = FairFace(mode="val", iat_type="gender", data_path=ff_root, download=False)
        model = tiny_model()
        out = {}
        for name, mesh in (("one", None), ("mesh", pmesh.create_mesh(devices=CPU8))):
            loader = HostLoader(ds, batch_size=10, num_workers=1, native_n_px=PX)
            out[name] = get_labels_img_embeddings(loader, model, n_px=PX, mesh=mesh)
        np.testing.assert_array_equal(out["mesh"][0], out["one"][0])
        # equal_split keeps 10 + 10 rows: two batches of 10, each ragged against 8
        assert out["mesh"][1].shape == (20, 16)
        torch.testing.assert_close(out["mesh"][1], out["one"][1], atol=1e-6, rtol=0)

    @pytest.mark.parametrize("sharded", [False, True])
    def test_measure_bias_mesh_equals_one_device(self, ff_root, sharded):
        model = tiny_model()
        want = measure(model, ff_root)
        got = measure(model, ff_root, mesh=pmesh.create_mesh(devices=CPU8),
                      sharded_metrics=sharded)
        assert set(got) == set(want) == {"maxskew", "ndkl"}
        for ev in want:
            assert got[ev] == pytest.approx(want[ev], abs=1e-6), ev

    def test_mesh_auto_on_the_cpu_is_one_slot(self, ff_root, monkeypatch):
        seen = []
        orig = pmesh.default_mesh
        monkeypatch.setattr(pmesh, "default_mesh", lambda d: seen.append(d) or orig(d))
        model = tiny_model()
        got = measure(model, ff_root, mesh="auto", sharded_metrics=True)
        assert seen == [torch.device("cpu")]
        want = measure(model, ff_root)
        for ev in want:
            assert got[ev] == pytest.approx(want[ev], abs=1e-6)


class TestZeroShotUnderMesh:
    def test_mesh_equals_one_device(self, tmp_path):
        from debias_vision_lang_torch.cli import FolderDataset
        from debias_vision_lang_torch.data.loader import HostLoader
        from debias_vision_lang_torch.eval.zero_shot import zero_shot_accuracy

        classes = ["cat", "dog", "bird"]
        rng = np.random.default_rng(9)
        for c in classes:
            os.makedirs(tmp_path / c)
            for i in range(5):
                Image.fromarray(rng.integers(0, 256, (PX, PX, 3), dtype=np.uint8)).save(
                    tmp_path / c / f"{i}.png")
        model = tiny_model()
        out = {}
        for name, mesh in (("one", None), ("mesh", pmesh.create_mesh(devices=CPU8)),
                           ("auto", "auto")):
            loader = HostLoader(FolderDataset(str(tmp_path)), batch_size=6, num_workers=1,
                                native_n_px=PX)
            out[name] = zero_shot_accuracy(model, tok, loader, classes, n_px=PX, mesh=mesh)
        assert out["mesh"] == out["one"] == out["auto"] and out["one"]["n"] == 15


class TestEngineUnderMesh:
    def test_buckets_start_at_the_data_size(self):
        from debias_vision_lang_torch.serve.engine import InferenceEngine

        mesh = pmesh.create_mesh(devices=CPU8)
        e = InferenceEngine(tiny_model(), tok, max_batch=4, mesh=mesh, device="cpu")
        assert e.min_bucket == 8 and e.max_batch == 8
        assert e.info()["mesh"] == {"data": 8, "model": 1}
        seen = []
        e.warmup(log=seen.append)
        assert seen == ["warmup: bucket 8"]

    def test_rows_equal_the_engine_without_a_mesh(self):
        from debias_vision_lang_torch.serve.engine import InferenceEngine

        rng = np.random.default_rng(5)
        imgs = [rng.integers(0, 256, (PX, PX, 3), dtype=np.uint8) for _ in range(19)]
        toks = list(tok([f"prompt {i}" for i in range(11)]))
        model = tiny_model()
        one = InferenceEngine(model, tok, max_batch=16, device="cpu")
        meshed = InferenceEngine(model, tok, max_batch=16, device="cpu",
                                 mesh=pmesh.create_mesh(devices=CPU8))
        np.testing.assert_allclose(meshed.embed_image_arrays(imgs),
                                   one.embed_image_arrays(imgs), atol=1e-6, rtol=0)
        np.testing.assert_allclose(meshed.embed_token_arrays(toks),
                                   one.embed_token_arrays(toks), atol=1e-6, rtol=0)

    def test_data_size_must_be_a_power_of_two(self, tiny_clip):
        """Refused with the JAX engine's message."""
        import jax

        from debias_vision_lang_torch.serve.engine import InferenceEngine
        from debias_vision_lang_tpu.models.loader import CLIP as JCLIP
        from debias_vision_lang_tpu.parallel.mesh import create_mesh as jcreate
        from debias_vision_lang_tpu.serve.engine import InferenceEngine as JEngine

        errs = []
        for make in (
                lambda: JEngine(JCLIP(params=tiny_clip[1], cfg=tiny_clip[0]),
                                mesh=jcreate((6, 1), devices=jax.devices()[:6])),
                lambda: InferenceEngine(tiny_model(), None, device="cpu",
                                        mesh=pmesh.create_mesh(
                                            devices=[torch.device("cpu")] * 6))):
            with pytest.raises(ValueError, match="power of two") as err:
                make()
            errs.append(str(err.value))
        assert errs[0] == errs[1]

    def test_a_multi_process_world_is_refused(self):
        from debias_vision_lang_torch.serve.engine import InferenceEngine

        mesh = pmesh.create_mesh(devices=CPU8)
        mesh.world = 2
        with pytest.raises(ValueError, match="one process per host"):
            InferenceEngine(tiny_model(), None, device="cpu", mesh=mesh)

    def test_serve_forever_resolves_auto(self, monkeypatch):
        from debias_vision_lang_torch.serve import server as tserver

        seen = {}

        class Stop(Exception):
            pass

        def engine(model, tokenizer, **kw):
            seen.update(kw)
            raise Stop

        monkeypatch.setattr(tserver, "InferenceEngine", engine)
        with pytest.raises(Stop):
            tserver.serve_forever(tiny_model(), None, mesh="auto", device="cpu")
        assert dict(seen["mesh"].shape) == {"data": 1, "model": 1}


class TestTrainerUnderMesh:
    """JAX's TestTrainerUnderMesh pattern: two steps under the mesh equal
    two steps without one."""

    def test_frozen_step_matches_one_device(self):
        m1, t1 = run_steps(make_trainer(None))
        m8, t8 = run_steps(make_trainer(pmesh.create_mesh(devices=CPU8)))
        assert [m["step"] for m in m8] == [1, 2]
        for a, b in zip(m1, m8):
            assert a == pytest.approx(b, rel=1e-6, abs=1e-7)
        torch.testing.assert_close(t8, t1, atol=1e-7, rtol=0)

    def test_step_from_embeddings_matches_one_device(self):
        t1, t8 = make_trainer(None), make_trainer(pmesh.create_mesh(devices=CPU8))
        images, labels, cap_images, cap_tokens = trainer_batch()
        img_e = t1.fns.embed_images(t1.model, torch.from_numpy(images)).numpy()
        cap_e = t1.fns.embed_images(t1.model, torch.from_numpy(cap_images)).numpy()
        for _ in range(2):
            a = t1.step_from_embeddings(img_e, labels, cap_e, cap_tokens)
            b = t8.step_from_embeddings(img_e, labels, cap_e, cap_tokens)
            assert a == pytest.approx(b, rel=1e-6, abs=1e-7)
        torch.testing.assert_close(t8.model.debias_tokens, t1.model.debias_tokens,
                                   atol=1e-7, rtol=0)

    def test_with_layers_differentiates_through_the_split(self):
        """n_train_vid_layers=1: the image tower embeds inside the loss, per
        shard, and its top layer moves as without the split.  Adam's first
        updates are ~lr x sign(g), so a near-zero gradient element flips with
        float32 rounding: the layer's update is held by its cosine."""
        init = dict(tiny_model(n_train_vid_layers=1).clip.named_parameters())
        out = {}
        for name, mesh in (("one", None), ("mesh", pmesh.create_mesh(devices=CPU8))):
            model = tiny_model(n_train_vid_layers=1)
            tr = make_trainer(mesh, model=model)
            assert tr.trains_image
            out[name] = (run_steps(tr), dict(model.clip.named_parameters()))
        (m1, t1), p1 = out["one"]
        (m8, t8), p8 = out["mesh"]
        for a, b in zip(m1, m8):
            assert a == pytest.approx(b, rel=1e-5, abs=1e-6)
        torch.testing.assert_close(t8, t1, atol=1e-6, rtol=0)
        moved = [n for n in p1 if n.startswith("visual.resblocks.1.")]
        u1, u8 = (torch.cat([(p[n] - init[n]).detach().flatten() for n in moved])
                  for p in (p1, p8))
        assert u1.norm() > 0
        assert torch.nn.functional.cosine_similarity(u1, u8, dim=0) >= 0.9999

    def test_indivisible_batch_raises(self):
        tr = make_trainer(pmesh.create_mesh(devices=CPU8))
        images, labels, cap_images, cap_tokens = trainer_batch(b=12)
        with pytest.raises(ValueError, match="does not divide"):
            tr.step(images, labels, cap_images, cap_tokens)


# ---------------------------------------------------------------------------
# init_distributed
# ---------------------------------------------------------------------------


class TestInitDistributed:
    def test_no_coordinator_is_a_noop(self, monkeypatch):
        for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
            monkeypatch.delenv(var, raising=False)
        assert pmesh.init_distributed() is False
        assert not torch.distributed.is_initialized()

    def test_already_initialized_short_circuits(self, monkeypatch):
        import torch.distributed as dist

        called = []
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_world_size", lambda: 4)
        monkeypatch.setattr(dist, "init_process_group", lambda **kw: called.append(kw))
        assert pmesh.init_distributed() is True
        assert called == []  # idempotent: no second handshake

    def test_torchrun_environment_forwarded(self, monkeypatch):
        import torch.distributed as dist

        seen = {}
        monkeypatch.setattr(dist, "init_process_group", lambda **kw: seen.update(kw))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for var, val in (("MASTER_ADDR", "10.0.0.1"), ("MASTER_PORT", "1234"),
                         ("WORLD_SIZE", "4"), ("RANK", "2")):
            monkeypatch.setenv(var, val)
        # still no world after the (mocked) handshake: False
        assert pmesh.init_distributed() is False
        assert seen == {"backend": "gloo", "init_method": "tcp://10.0.0.1:1234",
                        "world_size": 4, "rank": 2}

    def test_arguments_win_and_init_methods_pass_through(self, monkeypatch):
        import torch.distributed as dist

        seen = {}
        monkeypatch.setattr(dist, "init_process_group", lambda **kw: seen.update(kw))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
        pmesh.init_distributed("file:///tmp/rendezvous", 2, 1)
        assert seen["init_method"] == "file:///tmp/rendezvous"
        assert (seen["world_size"], seen["rank"]) == (2, 1)

    def test_backend_is_gloo_when_ranks_share_a_card(self, monkeypatch):
        import torch.distributed as dist

        seen = {}
        monkeypatch.setattr(dist, "init_process_group", lambda **kw: seen.update(kw))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
        pmesh.init_distributed("localhost:1", 2, 0)
        assert seen["backend"] == "gloo"

    def test_missing_rank_raises(self, monkeypatch):
        for var in ("WORLD_SIZE", "RANK"):
            monkeypatch.delenv(var, raising=False)
        with pytest.raises(ValueError, match="WORLD_SIZE"):
            pmesh.init_distributed("localhost:1")


class TestCli:
    @pytest.mark.parametrize("argv", [
        ["measure-bias", "--mesh", "auto", "--sharded-metrics"],
        ["train", "--mesh", "auto"], ["serve", "--mesh", "auto"]])
    def test_mesh_flags_reach_the_entry_points_after_init_distributed(self, monkeypatch,
                                                                      argv):
        from debias_vision_lang_torch import cli, serve
        from debias_vision_lang_torch.eval import measure as tmeasure
        from debias_vision_lang_torch.models import loader
        from debias_vision_lang_torch.train import loop

        order = []
        monkeypatch.setattr(pmesh, "init_distributed", lambda: order.append("init"))
        monkeypatch.setattr(loader, "model_loader",
                            lambda *a, **k: ("model", "preprocess", "tok", "alias"))
        seen = {}

        def entry(name):
            def call(*a, **k):
                order.append(name)
                seen.update(k)
                return {}
            return call

        monkeypatch.setattr(tmeasure, "measure_bias", entry("measure-bias"))
        monkeypatch.setattr(loop, "run_training", entry("train"))
        monkeypatch.setattr(serve, "serve_forever", entry("serve"))
        cli.main(argv + ["--device", "cpu", "--random-weights"])
        assert order == ["init", argv[0]]
        if argv[0] == "measure-bias":
            assert seen["opts"]["mesh"] == "auto" and seen["opts"]["sharded_metrics"]
        else:
            assert seen["mesh"] == "auto"

    def test_light_commands_start_no_world(self, monkeypatch):
        from debias_vision_lang_torch import cli

        called = []
        monkeypatch.setattr(pmesh, "init_distributed", lambda: called.append(1))
        with pytest.raises(SystemExit):
            cli.main(["download", "bpe"])
        assert called == []

    def test_bench_starts_the_world_first(self, monkeypatch):
        """``bench`` is one of the JAX CLI's heavy commands (``_HEAVY_CMDS``):
        the world comes up before the bench runs."""
        from debias_vision_lang_torch import cli

        order = []
        monkeypatch.setattr(pmesh, "init_distributed", lambda: order.append("init"))
        monkeypatch.setattr(cli, "_run_bench", lambda path, argv: order.append("bench"))
        cli.main(["bench", "--device", "cpu"])
        assert order == ["init", "bench"]


# ---------------------------------------------------------------------------
# A two-rank gloo world
# ---------------------------------------------------------------------------


LAYER_CONFIGS = {"vid_layers": {"n_train_vid_layers": 1}, "proj": {"freeze_proj": False}}
LAYER_STEPS = 3


def train_image_layers(mesh, dkw, steps=LAYER_STEPS):
    """``steps`` steps of a trainer whose image-path parameters train: the
    joint optimizer's tensor names, the first gradients handed to it, the
    tensors before the first step and the first update of each, and after
    each step every trained tensor, the adversary's and both optimizers'
    Adam moments (host copies)."""
    from debias_vision_lang_torch.train.adversarial import joint_params

    tr = make_trainer(mesh, model=tiny_model(**dkw))
    assert tr.trains_image
    opt = tr.prompt_opt
    first = {"names": ["debias_tokens"] + joint_params(tr.model, tr.grad_mask)[0]}
    step = opt.step

    def record(grads):
        if "grad" not in first:
            first["grad"] = [g.detach().clone() for g in grads]
            first["before"] = [p.detach().clone() for p in opt.params]
        step(grads)

    opt.step = record
    states = []
    batch = trainer_batch()
    for _ in range(steps):
        tr.step(*batch)
        adam = [v.detach().clone() for o in (tr.prompt_opt, tr.adv_opt)
                for s in o.adam.state.values() for v in s.values()]
        states.append([p.detach().clone() for p in opt.params]
                      + [p.detach().clone() for p in tr.adversary.parameters()] + adam)
        if len(states) == 1:
            first["update"] = [p.detach() - b for p, b in zip(opt.params, first["before"])]
    return {**first, "states": states}


def world_rank(init_file: str, rank: int, ff_root: str, out: str) -> None:
    """One rank: join the world, measure with the auto mesh and sharded
    metrics, take two frozen trainer steps under the auto mesh, then train
    the image path (each of LAYER_CONFIGS) under it."""
    torch.set_num_threads(1)
    assert pmesh.init_distributed("file://" + init_file, 2, rank)
    try:
        mesh = pmesh.default_mesh("cpu")
        res = measure(tiny_model(), ff_root, mesh="auto", sharded_metrics=True)
        metrics, tokens = run_steps(make_trainer("auto"))
        with open(out, "w") as f:
            json.dump({"measure": res, "train": metrics, "tokens": tokens.tolist(),
                       "mesh": dict(mesh.shape), "world": mesh.world,
                       "collectives": dict(pmesh.COLLECTIVES)}, f)
        torch.save({name: train_image_layers("auto", dkw)
                    for name, dkw in LAYER_CONFIGS.items()}, out + ".layers.pt")
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def world_runs(tmp_path_factory, ff_root):
    """Both ranks' outputs of one two-rank gloo world (this file run as a
    script, once per rank)."""
    tmp = tmp_path_factory.mktemp("world")
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(var, None)
    init = str(tmp / "rendezvous")
    outs = [str(tmp / f"rank{r}.json") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), init, str(r),
                               ff_root, outs[r]], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    return ([json.load(open(o)) for o in outs],
            [torch.load(o + ".layers.pt", weights_only=True) for o in outs])


def test_two_rank_gloo_world(world_runs, ff_root):
    ranks, _ = world_runs
    assert all(r["world"] == 2 and r["mesh"] == {"data": 2, "model": 1} for r in ranks)
    assert all(r["collectives"].get("gloo", 0) > 0 for r in ranks)
    assert ranks[0]["measure"] == ranks[1]["measure"]
    assert ranks[0]["tokens"] == ranks[1]["tokens"]
    assert ranks[0]["train"] == ranks[1]["train"]

    want = measure(tiny_model(), ff_root)
    for ev in want:
        assert ranks[0]["measure"][ev] == pytest.approx(want[ev], abs=1e-5), ev
    _, tokens = run_steps(make_trainer(None))
    np.testing.assert_allclose(np.asarray(ranks[0]["tokens"]), tokens.numpy(),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("config", list(LAYER_CONFIGS))
def test_two_rank_world_trains_image_layers(world_runs, config):
    """Image-path parameters train across two ranks: the ranks bit-equal
    after every step; the first gradient of every tensor the joint optimizer
    holds (prompt array, every trained CLIP tensor, ``logit_scale`` too,
    whose gradient is whole on each rank and is not summed) within 1e-5 of
    its largest magnitude in the one-process 8-slot mesh's step, and the
    first update within 1e-5 of the updated tensor's largest magnitude (the
    update is a difference of parameters: rounding the step into them
    leaves an ulp of the parameter).  The key third of ``bqkv`` has a zero gradient in
    exact arithmetic (a softmax row is shift-invariant): both runs step it
    on rounding noise at Adam's eps, so it is held to 3 x lr of its start,
    as in tests/test_torch_train.py."""
    _, layers = world_runs
    a, b = (r[config] for r in layers)
    assert len(a["states"]) == LAYER_STEPS
    for step, (sa, sb) in enumerate(zip(a["states"], b["states"])):
        assert all(torch.equal(x, y) for x, y in zip(sa, sb, strict=True)), step
    one = train_image_layers(pmesh.create_mesh(devices=CPU8), LAYER_CONFIGS[config], steps=1)
    assert a["names"] == one["names"]
    assert any(n.startswith("visual.") for n in one["names"])
    lr = TrainConfig().prompt_lr
    for name, g, gw, u, uw, p in zip(one["names"], a["grad"], one["grad"], a["update"],
                                     one["update"], one["before"], strict=True):
        assert (g - gw).abs().max() <= 1e-5 * gw.abs().max(), name
        if name.endswith("attn.bqkv"):
            d = u.shape[-1] // 3
            assert u[..., d:2 * d].abs().max() <= 3 * lr, name
            u, uw, p = (torch.cat([t[..., :d], t[..., 2 * d:]], -1) for t in (u, uw, p))
        assert (u - uw).abs().max() <= 1e-5 * (p + uw).abs().max(), name
    moved = torch.cat([u.flatten() for u in one["update"][1:]])
    assert moved.abs().max() > 0  # the CLIP tensors train


if __name__ == "__main__":
    world_rank(sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4])
