"""Tensor parallel in the PyTorch port (debias_vision_lang_torch/parallel/
tensor.py and the five functions of parallel/mesh.py) against the JAX
package's, on CPU slots.

  * The PartitionSpec trees of ``clip_param_pspecs``,
    ``quantized_resblock_pspecs`` and ``quantized_tower_pspecs`` against
    JAX's, leaf for leaf (a ViT, a ModifiedResNet and a Frozen-in-Time
    tree; the int8 ViT, SLIP, text and video towers, whose temporal
    attention stays replicated).
  * float32 (the plain route): under (4, 2) the tensor-parallel logits
    within 1e-4 of JAX's unsharded ``clip.forward(use_pallas=False)`` (the
    bar of tests/test_parallel.py::test_tp_forward_matches_replicated) and
    within 1e-5 of the port's unsharded forward; the SLIP, Frozen-in-Time
    (joint and divided) and DebiasCLIP text towers within 1e-5 of unsharded.
  * int8: under (4, 2) both int8 towers within 1e-5 of JAX's single-device
    ``QuantizedCLIP`` embeddings (tests/test_parallel.py::
    test_tp_int8_towers_match_single_device's bar) and bit-equal to the
    port's unsharded int8 towers, on the plain int8 layers (float32) and on
    the split kernels' twins (bfloat16), the Frozen-in-Time towers too.
  * bfloat16: each split block through the kernels' twins within one bf16
    ulp of the unsharded K1 / K2 twins, under (1, 2) and (1, 4).
  * KB (a) 6: ``attention_block_hgrid_plain`` against JAX's
    ``benchmarks/attn_variants.py::attention_block_hgrid`` in interpret mode
    (``pl.pallas_call`` patched on the module object, restored by
    monkeypatch) at B=2 S=8 D=128 H=2: 2e-5 at float32, one bf16 ulp at
    bfloat16.
  * The dryrun step (JAX's ``__graft_entry__.dryrun_multichip``): one
    float32 adversary + prompt step on a DebiasCLIP whose CLIP is placed
    under (2, 2); the token gradient within 1e-5 of the unsharded step's
    largest magnitude.
  * Refusals: only JAX's (D % m or F % m), naming the shape; heads that do
    not divide over m place and compute as JAX's column split does
    (tests/test_torch_tp_shapes.py holds the rest of that contract).
  * CUDA (marker ``cuda``, skipped without a card): each new entry against
    its twin, and the int8 split tower bit-equal to the unsharded kernels.

The CUDA tests import no jax:  python -m pytest
tests/test_torch_tensor_parallel.py -m cuda --noconftest -p no:randomly
"""

import functools
import importlib.util
import math
import pathlib
import shutil

import numpy as np
import pytest
import torch

from debias_vision_lang_torch.core.config import (CLIPConfig, DebiasConfig, TextConfig,
                                                  VisionConfig)
from debias_vision_lang_torch.models.clip import CLIP, init_clip_params
from debias_vision_lang_torch.models.debias import DebiasCLIP, trainable_mask
from debias_vision_lang_torch.ops import fused_block as fb
from debias_vision_lang_torch.ops import fused_block_q as fbq
from debias_vision_lang_torch.ops.quant import QuantizedCLIP
from debias_vision_lang_torch.parallel import mesh as pm
from debias_vision_lang_torch.parallel import tensor as tpar

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def cpu_mesh(d, m):
    return pm.create_mesh((d, m), devices=[CPU] * (d * m))


def tiny_cfg(heads=2, text_heads=2, kind="vit", width=64, attention="joint"):
    return CLIPConfig(
        name="tiny-tp",
        vision=VisionConfig(kind=kind, image_size=32, patch_size=8, width=width, layers=2,
                            heads=heads, embed_dim=32, video_attention=attention),
        text=TextConfig(vocab_size=512, context_length=16, width=32, layers=2,
                        heads=text_heads, embed_dim=32))


def perturbed(model, seed=0, std=0.02):
    """Every parameter moved off its init (biases and LayerNorms included),
    from a numpy seed."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.tensor(rng.normal(size=tuple(p.shape)) * std, dtype=torch.float32))
    return model.eval()


def port_clip(cfg, seed=0):
    if cfg.vision.kind == "video_vit":
        from debias_vision_lang_torch.models.frozen_in_time import FrozenInTime

        model = FrozenInTime(cfg)
    else:
        model = CLIP(cfg)
    model.load_state_dict(init_clip_params(cfg, torch.Generator().manual_seed(seed)))
    return perturbed(model, seed)


def images(n=8, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(n, 32, 32, 3))
                            .astype(np.float32))


def tokens(n=4, seed=2, ctx=16, vocab=512):
    rng = np.random.default_rng(seed)
    t = np.zeros((n, ctx), np.int64)
    t[:, 0] = vocab - 2
    t[:, 1] = rng.integers(1, 100, n)
    t[:, 2] = rng.integers(1, 100, n)
    t[:, 3] = vocab - 1
    return torch.from_numpy(t)


def ulp_bf16(mag):
    return 2.0 ** (math.floor(math.log2(mag)) - 7)


def within_one_ulp(got, ref):
    got, ref = got.detach().float(), ref.detach().float()
    tol = ulp_bf16(ref.abs().max().item())
    err = (got - ref).abs().max().item()
    assert err <= tol, f"max err {err} > 1 bf16 ulp {tol}"


def close(got, want, tol):
    err = (got.detach().float() - want.detach().float()).abs().max().item()
    assert err <= tol, f"max err {err} > {tol}"


def spec_tree(tree):
    """A spec tree with every leaf as a plain tuple (JAX's PartitionSpec and
    the port's are both tuples of axis names)."""
    if isinstance(tree, dict):
        return {k: spec_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [spec_tree(v) for v in tree]
    return tuple(tree)


# ---------------------------------------------------------------------------
# PartitionSpec trees against JAX's
# ---------------------------------------------------------------------------


def _jax_params(cfg, seed=0):
    import jax

    from debias_vision_lang_tpu.models.clip import init_clip_params as jinit

    return jinit(jax.random.key(seed), cfg)


def _jax_cfg(cfg):
    from debias_vision_lang_tpu.core import config as jconfig

    def conv(obj):
        import dataclasses

        cls = getattr(jconfig, type(obj).__name__)
        return cls(**{f.name: conv(getattr(obj, f.name)) if dataclasses.is_dataclass(
            getattr(obj, f.name)) else getattr(obj, f.name)
            for f in dataclasses.fields(obj) if f.init})

    return conv(cfg)


class TestPartitionSpecs:
    @pytest.mark.parametrize("kind", ["vit", "resnet", "video_vit"])
    def test_clip_param_pspecs_are_jax_s(self, kind):
        from debias_vision_lang_tpu.parallel.mesh import clip_param_pspecs as jspecs

        if kind == "resnet":
            cfg = CLIPConfig(name="rn", vision=VisionConfig(
                kind="resnet", image_size=64, patch_size=32, width=16, layers=(1, 1, 1, 1),
                heads=8, embed_dim=32), text=tiny_cfg().text)
        else:
            cfg = tiny_cfg(kind=kind)
        jcfg = _jax_cfg(cfg)
        if kind == "video_vit":
            import jax

            from debias_vision_lang_tpu.models.frozen_in_time import init_fit_params

            jparams = init_fit_params(jax.random.key(0), jcfg, num_frames=4)
        else:
            jparams = _jax_params(jcfg)
        want = spec_tree(jspecs(jparams))
        got = spec_tree(pm.clip_param_pspecs(port_clip(cfg)))
        assert got == want
        assert spec_tree(pm.clip_param_pspecs(jparams)) == want  # JAX's tree as given
        if kind == "resnet":
            assert all(leaf == () for leaf in _leaves(got["visual"]))
        else:
            assert got["visual"]["resblocks"]["attn"]["wqkv"] == (None, None, "model")
        assert got["text"]["resblocks"]["mlp"]["w2"] == (None, "model", None)

    def test_quantized_resblock_pspecs_are_jax_s(self):
        from debias_vision_lang_tpu.parallel.mesh import quantized_resblock_pspecs as jq

        assert spec_tree(pm.quantized_resblock_pspecs()) == spec_tree(jq())
        assert spec_tree(pm.quantized_resblock_pspecs("m")) == spec_tree(jq("m"))

    @pytest.mark.parametrize("tower", ["vit visual", "slip visual", "text", "video visual"])
    def test_quantized_tower_pspecs_are_jax_s(self, tower):
        from debias_vision_lang_tpu.models.loader import CLIP as JCLIP
        from debias_vision_lang_tpu.ops.quant import QuantizedCLIP as JQ
        from debias_vision_lang_tpu.parallel.mesh import quantized_tower_pspecs as jq

        kind = {"slip visual": "slip_vit", "video visual": "video_vit"}.get(tower, "vit")
        cfg = tiny_cfg(kind=kind)
        jcfg = _jax_cfg(cfg)
        if kind == "video_vit":
            import jax

            from debias_vision_lang_tpu.models.frozen_in_time import init_fit_params

            jparams = init_fit_params(jax.random.key(0), jcfg, num_frames=4)
        else:
            jparams = _jax_params(jcfg)
        jmodel = JQ(JCLIP(params=jparams, cfg=jcfg), quantize_text=True)
        tmodel = QuantizedCLIP(port_clip(cfg), quantize_text=True)
        jt, tt = ((jmodel.text_q, tmodel.text_q) if tower == "text"
                  else (jmodel.visual_q, tmodel.visual_q))
        want = spec_tree(jq(jt))
        assert spec_tree(pm.quantized_tower_pspecs(tt)) == want
        assert spec_tree(pm.quantized_tower_pspecs(jt)) == want
        if kind == "video_vit":
            assert all(leaf == () for leaf in _leaves(want["temporal_attn"]))

    def test_partition_spec_is_a_tuple_of_axes(self):
        p = pm.PartitionSpec(None, "model")
        assert p == (None, "model") and pm.PartitionSpec() == ()
        assert repr(p) == "PartitionSpec(None, 'model')"


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# float32: the plain route
# ---------------------------------------------------------------------------


class TestFloat32:
    def test_tp_forward_matches_jax_unsharded(self, tiny_clip):
        """tests/test_parallel.py::test_tp_forward_matches_replicated on the
        port: (4, 2), float32, logits within 1e-4 of JAX's unsharded
        forward (use_pallas=False) and 1e-5 of the port's."""
        import jax
        import jax.numpy as jnp

        from debias_vision_lang_tpu.models import clip as jclip
        from debias_vision_lang_torch.models.convert import params_from_jax
        from torch_port_config import port_config

        cfg, params = tiny_clip
        rng = np.random.default_rng(1)
        imgs = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
        v = cfg.text.vocab_size
        t = np.zeros((4, 16), np.int32)
        t[:, 0] = v - 2
        t[:, 1] = rng.integers(1, 100, 4)
        t[:, 2] = v - 1
        base, _ = jclip.forward(params, jnp.asarray(imgs), jnp.asarray(t), cfg,
                                use_pallas=False)
        tcfg = port_config(cfg)
        clip = CLIP(tcfg)
        clip.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tcfg))
        clip.eval()
        placed = pm.shard_clip_params(clip, cpu_mesh(4, 2))
        with torch.no_grad():
            got, _ = placed(torch.from_numpy(imgs), torch.from_numpy(t.astype(np.int64)))
            one, _ = clip(torch.from_numpy(imgs), torch.from_numpy(t.astype(np.int64)))
        np.testing.assert_allclose(got.numpy(), np.asarray(base), atol=1e-4)
        close(got, one, 1e-5)

    @pytest.mark.parametrize("shape", [(1, 2), (2, 2), (4, 2), (1, 4), (2, 4), (8, 1)])
    def test_tp_logits_match_unsharded(self, shape):
        clip = port_clip(tiny_cfg(heads=4, text_heads=4))
        placed = pm.shard_clip_params(clip, cpu_mesh(*shape))
        with torch.no_grad():
            got, _ = placed(images(), tokens())
            want, _ = clip(images(), tokens())
        close(got, want, 1e-5)

    @pytest.mark.parametrize("kind,attention", [("slip_vit", "joint"), ("video_vit", "joint"),
                                                ("video_vit", "divided")])
    def test_tp_image_towers_match_unsharded(self, kind, attention):
        clip = port_clip(tiny_cfg(kind=kind, attention=attention))
        if kind == "video_vit":
            with torch.no_grad():  # the init zeroes the temporal path's output
                ta = clip.visual.temporal_attn.attn
                ta.wo.copy_(torch.randn(ta.wo.shape, generator=torch.Generator().manual_seed(4))
                            * 0.1)
                clip.visual.temporal_embedding.normal_(0, 0.5)
        x = (torch.from_numpy(np.random.default_rng(5).normal(size=(4, 4, 32, 32, 3))
                              .astype(np.float32)) if kind == "video_vit" else images())
        placed = pm.shard_clip_params(clip, cpu_mesh(2, 2))
        assert isinstance(placed.visual.resblocks, tpar.TensorParallelBlocks)
        if kind == "video_vit":  # the divided tower's temporal attention: replicated
            assert not isinstance(placed.visual.temporal_attn, tpar.TensorParallelBlocks)
        with torch.no_grad():
            close(placed.encode_image(x), clip.encode_image(x), 1e-5)

    def test_debias_prompt_injection_through_tp_text_tower(self):
        clip = port_clip(tiny_cfg())
        toks = torch.randn(2, 32, generator=torch.Generator().manual_seed(3)) * 0.02
        model = DebiasCLIP(clip, toks, DebiasConfig(num_debias_tokens=2, hidden_dim=32,
                                                    max_tokens=16))
        placed = pm.shard_clip_params(model, cpu_mesh(2, 2))
        assert isinstance(placed, DebiasCLIP)
        assert isinstance(placed.clip.text.resblocks, tpar.TensorParallelBlocks)
        with torch.no_grad():
            close(placed.encode_text(tokens()), model.encode_text(tokens()), 1e-5)

    def test_remat_and_use_pallas_routes(self):
        clip = port_clip(tiny_cfg())
        placed = pm.shard_clip_params(clip, cpu_mesh(1, 2))
        x = images(4).requires_grad_(True)
        got = placed.encode_image(x, remat=True)
        (g,) = torch.autograd.grad(got.sum(), x)
        want = clip.encode_image(x)
        (g1,) = torch.autograd.grad(want.sum(), x)
        close(got, want, 1e-5)
        close(g, g1, 1e-5 * g1.abs().max().item())

    def test_placement_leaves_the_source_and_keeps_the_layer_names(self):
        clip = port_clip(tiny_cfg())
        before = {k: v.clone() for k, v in clip.state_dict().items()}
        placed = pm.shard_clip_params(clip, cpu_mesh(4, 2))
        assert all(torch.equal(v, clip.state_dict()[k]) for k, v in before.items())
        assert len(placed.visual.resblocks) == 2 and len(placed.text.resblocks) == 2
        names = [n for n, _ in placed.named_parameters()]
        assert "visual.resblocks.1.slots.0.wqkv" in names
        assert "text.resblocks.0.slots.1.w2" in names
        # a virtual (4, 2) mesh on one device holds one shard per model index
        assert len(placed.visual.resblocks[0].slots) == 2
        sh = placed.visual.resblocks[0].slots[1]
        assert tuple(sh.wqkv.shape) == (64, 96) and tuple(sh.wo.shape) == (32, 64)
        assert tuple(sh.w1.shape) == (64, 128) and tuple(sh.w2.shape) == (128, 64)
        mask = trainable_mask(placed, DebiasConfig(num_debias_tokens=2, hidden_dim=32,
                                                   max_tokens=16, n_train_text_layers=1))
        assert mask["text.resblocks.1.slots.0.wqkv"] == 1.0
        assert mask["text.resblocks.0.slots.0.wqkv"] == 0.0

    def test_head_columns_take_whole_heads_of_q_k_and_v(self):
        cols = tpar.head_columns(128, 2, 1, 2)
        assert cols.tolist() == (list(range(64, 128)) + list(range(192, 256))
                                 + list(range(320, 384)))


# ---------------------------------------------------------------------------
# int8
# ---------------------------------------------------------------------------


class TestInt8:
    def test_tp_int8_towers_match_jax_single_device(self, tiny_clip):
        """tests/test_parallel.py::test_tp_int8_towers_match_single_device on
        the port: (4, 2), both towers within 1e-5 of JAX's single-device
        int8 embeddings, and bit-equal to the port's unsharded int8 towers."""
        import jax
        import jax.numpy as jnp

        from debias_vision_lang_tpu.models.loader import CLIP as JCLIP
        from debias_vision_lang_tpu.ops.quant import QuantizedCLIP as JQ
        from debias_vision_lang_torch.models.convert import params_from_jax
        from torch_port_config import port_config

        cfg, params = tiny_clip
        jq = JQ(JCLIP(params=params, cfg=cfg), quantize_text=True)
        rng = np.random.default_rng(8)
        imgs = rng.normal(size=(16, 32, 32, 3)).astype(np.float32)
        toks = tokens(16, seed=9).numpy()
        i_single = np.asarray(jq.encode_image(jnp.asarray(imgs), dtype=jnp.float32))
        t_single = np.asarray(jq.encode_text(jnp.asarray(toks.astype(np.int32)),
                                             dtype=jnp.float32))
        tcfg = port_config(cfg)
        clip = CLIP(tcfg)
        clip.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tcfg))
        q = QuantizedCLIP(clip.eval(), quantize_text=True)
        q_tp = pm.shard_quantized_clip(q, cpu_mesh(4, 2))
        with torch.no_grad():
            i_tp = q_tp.encode_image(torch.from_numpy(imgs), dtype=torch.float32)
            t_tp = q_tp.encode_text(torch.from_numpy(toks), dtype=torch.float32)
            i_one = q.encode_image(torch.from_numpy(imgs), dtype=torch.float32)
            t_one = q.encode_text(torch.from_numpy(toks), dtype=torch.float32)
        np.testing.assert_allclose(i_tp.numpy(), i_single, atol=1e-5)
        np.testing.assert_allclose(t_tp.numpy(), t_single, atol=1e-5)
        assert torch.equal(i_tp, i_one) and torch.equal(t_tp, t_one)

    @pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4), (4, 2)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_tp_int8_towers_bit_equal_unsharded(self, shape, dtype):
        """float32: the plain int8 layers; bfloat16: the split kernels' twins."""
        dt = getattr(torch, dtype)
        q = QuantizedCLIP(port_clip(tiny_cfg(heads=4, text_heads=4)), quantize_text=True)
        q_tp = pm.shard_quantized_clip(q, cpu_mesh(*shape))
        assert isinstance(q_tp.visual_q.resblocks, tpar.TensorParallelQBlocks)
        assert not isinstance(q.visual_q.resblocks, tpar.TensorParallelQBlocks)
        with torch.no_grad():
            assert torch.equal(q_tp.encode_image(images(), dtype=dt),
                               q.encode_image(images(), dtype=dt))
            assert torch.equal(q_tp.encode_text(tokens(), dtype=dt),
                               q.encode_text(tokens(), dtype=dt))

    @pytest.mark.parametrize("attention", ["joint", "divided"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_tp_int8_video_towers_bit_equal_unsharded(self, attention, dtype):
        dt = getattr(torch, dtype)
        clip = port_clip(tiny_cfg(kind="video_vit", attention=attention))
        with torch.no_grad():
            clip.visual.temporal_attn.attn.wo.normal_(0, 0.1)
        q = QuantizedCLIP(clip)
        q_tp = pm.shard_quantized_clip(q, cpu_mesh(1, 2))
        x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 4, 32, 32, 3))
                             .astype(np.float32))
        with torch.no_grad():
            assert torch.equal(q_tp.encode_image(x, dtype=dt), q.encode_image(x, dtype=dt))

    def test_tp_int8_text_debias_injection(self):
        clip = port_clip(tiny_cfg())
        model = DebiasCLIP(clip, torch.randn(2, 32, generator=torch.Generator().manual_seed(7))
                           * 0.02, DebiasConfig(num_debias_tokens=2, hidden_dim=32,
                                                max_tokens=16))
        q = QuantizedCLIP(model, quantize_text=True)
        q_tp = pm.shard_quantized_clip(q, cpu_mesh(2, 2))
        with torch.no_grad():
            assert torch.equal(q_tp.encode_text(tokens()), q.encode_text(tokens()))

    def test_a_resnet_int8_tower_stays_replicated(self):
        cfg = CLIPConfig(name="rn", vision=VisionConfig(
            kind="resnet", image_size=64, patch_size=32, width=16, layers=(1, 1, 1, 1),
            heads=8, embed_dim=32), text=tiny_cfg().text)
        q = QuantizedCLIP(port_clip(cfg), quantize_text=True)
        q_tp = pm.shard_quantized_clip(q, cpu_mesh(1, 2))
        assert isinstance(q_tp.text_q.resblocks, tpar.TensorParallelQBlocks)
        assert not hasattr(q_tp.visual_q, "resblocks")
        x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 64, 64, 3))
                             .astype(np.float32))
        with torch.no_grad():
            assert torch.equal(q_tp.encode_image(x, dtype=torch.float32),
                               q.encode_image(x, dtype=torch.float32))


# ---------------------------------------------------------------------------
# bfloat16: the split kernels' twins per block
# ---------------------------------------------------------------------------


def _block_np(rng, d, f):
    def rn(*shape, std=1.0):
        return torch.from_numpy((rng.normal(size=shape) * std).astype(np.float32))

    return {"ln_1": (1 + rn(d, std=0.1), rn(d, std=0.1)),
            "attn": (rn(d, 3 * d, std=d ** -0.5), rn(3 * d, std=0.1), rn(d, d, std=d ** -0.5),
                     rn(d, std=0.1)),
            "ln_2": (1 + rn(d, std=0.1), rn(d, std=0.1)),
            "mlp": (rn(d, f, std=(2 * d) ** -0.5), rn(f, std=0.1), rn(f, d, std=f ** -0.5),
                    rn(d, std=0.1))}


def _resblock(p):
    from debias_vision_lang_torch.models.layers import ResidualBlock

    d = p["ln_1"][0].shape[0]
    blk = ResidualBlock(d)
    sd = {"ln_1.scale": p["ln_1"][0], "ln_1.bias": p["ln_1"][1], "ln_2.scale": p["ln_2"][0],
          "ln_2.bias": p["ln_2"][1]}
    sd.update(zip(("attn.wqkv", "attn.bqkv", "attn.wo", "attn.bo"), p["attn"]))
    sd.update(zip(("mlp.w1", "mlp.b1", "mlp.w2", "mlp.b2"), p["mlp"]))
    blk.load_state_dict(sd)
    return blk


class TestBf16Twins:
    @pytest.mark.parametrize("m", [2, 4])
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("scale", [1.0, 1 / 16])
    def test_split_block_within_one_ulp_of_k1_k2(self, m, causal, scale):
        d, heads = 128, 4
        p = _block_np(np.random.default_rng(m), d, 4 * d)
        blk = _resblock(p)
        tp = tpar.TensorParallelBlocks(torch.nn.ModuleList([blk]), cpu_mesh(1, m), heads)
        x = (torch.from_numpy(np.random.default_rng(9).normal(size=(3, 13, d))
                              .astype(np.float32)) * scale).to(torch.bfloat16)
        with torch.no_grad():
            got = tp.block(0, x, route="fused", causal=causal)
            y = fb.attention_block_plain(x, *p["ln_1"], *p["attn"], heads=heads, causal=causal)
            want = fb.mlp_block_plain(y, *p["ln_2"], *p["mlp"])
        within_one_ulp(got, want)
        # the attention half alone: the reduce of the head groups' partials
        parts = [fb.attention_block_heads(x, *p["ln_1"], sh.wqkv, sh.bqkv, sh.wo,
                                          heads=heads // m, causal=causal)
                 for sh in tp[0].slots]
        within_one_ulp(fb.tp_reduce(parts, p["attn"][3], x, bias_first=False), y)

    def test_gradients_flow_through_the_split_blocks(self):
        """The bf16 route with a gradient: the twins' recompute backward gives
        the same gradients as autograd through the twins directly."""
        clip = port_clip(tiny_cfg(heads=4))
        placed = pm.shard_clip_params(clip, cpu_mesh(2, 2))
        x = images(4).requires_grad_(True)
        out = placed.encode_image(x, dtype=torch.bfloat16).float()
        (g,) = torch.autograd.grad(out.sum(), x)
        assert torch.isfinite(g).all() and g.abs().max() > 0
        out1 = clip.encode_image(x, dtype=torch.bfloat16).float()
        (g1,) = torch.autograd.grad(out1.sum(), x)
        cos = torch.nn.functional.cosine_similarity(g.flatten(), g1.flatten(), dim=0)
        assert cos > 0.999, cos

    def test_cpu_route_never_counts(self):
        fb.reset_launches()
        fbq.reset_launches()
        clip = port_clip(tiny_cfg())
        placed = pm.shard_clip_params(clip, cpu_mesh(1, 2))
        with torch.no_grad():
            placed.encode_image(images(2), dtype=torch.bfloat16)
        assert sum(fb.TP_LAUNCHES.values()) == 0 and sum(fb.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# KB (a) 6: attention_block_hgrid against the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.fixture
def attn_variants(monkeypatch):
    """benchmarks/attn_variants.py with its pallas_call in interpret mode."""
    spec = importlib.util.spec_from_file_location(
        "attn_variants_interpret", REPO / "benchmarks" / "attn_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod.pl, "pallas_call",
                        functools.partial(mod.pl.pallas_call, interpret=True))
    return mod


def _hgrid_inputs(dtype, b=2, s=8, d=128, heads=2, seed=0):
    """KB's operands as its main() builds them: pre-scaled q columns, per-head
    [d, 3 hd] blocks, wo as [H hd, d]."""
    rng = np.random.default_rng(seed)
    hd = d // heads
    lns = (1 + 0.02 * rng.normal(size=d)).astype(np.float32)
    lnb = (0.02 * rng.normal(size=d)).astype(np.float32)
    wqkv = (rng.normal(size=(d, 3 * d)) * d ** -0.5).astype(np.float32)
    bqkv = (0.02 * rng.normal(size=3 * d)).astype(np.float32)
    wo = (rng.normal(size=(d, d)) * d ** -0.5).astype(np.float32)
    bo = (0.02 * rng.normal(size=d)).astype(np.float32)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    scale = hd ** -0.5 * math.log2(math.e)
    wq = np.concatenate([wqkv[:, :d] * scale, wqkv[:, d:]], axis=1)
    bq = np.concatenate([bqkv[:d] * scale, bqkv[d:]])
    wqkv_h = np.stack([np.concatenate([wq[:, i * d + h * hd:i * d + (h + 1) * hd]
                                       for i in range(3)], axis=1) for h in range(heads)])
    bqkv_h = np.stack([np.concatenate([bq[i * d + h * hd:i * d + (h + 1) * hd]
                                       for i in range(3)]) for h in range(heads)])
    return dict(x=x, lns=lns, lnb=lnb, wqkv_h=wqkv_h, bqkv_h=bqkv_h, wo_h=wo, bo=bo,
                heads=heads, wqkv=wqkv, bqkv=bqkv, dtype=dtype)


class TestHgrid:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_twin_matches_the_pallas_kernel(self, attn_variants, dtype):
        import jax.numpy as jnp

        a = _hgrid_inputs(dtype)
        jdt = getattr(jnp, dtype)
        want = attn_variants.attention_block_hgrid(
            jnp.asarray(a["x"], jdt), jnp.asarray(a["lns"]), jnp.asarray(a["lnb"]),
            jnp.asarray(a["wqkv_h"], jdt), jnp.asarray(a["bqkv_h"]), jnp.asarray(a["wo_h"], jdt),
            jnp.asarray(a["bo"]), heads=a["heads"])
        want = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
        tdt = getattr(torch, dtype)
        got = fb.attention_block_hgrid(
            torch.from_numpy(a["x"]).to(tdt), torch.from_numpy(a["lns"]),
            torch.from_numpy(a["lnb"]), torch.from_numpy(a["wqkv_h"]).to(tdt),
            torch.from_numpy(a["bqkv_h"]), torch.from_numpy(a["wo_h"]).to(tdt),
            torch.from_numpy(a["bo"]), heads=a["heads"])
        if dtype == "float32":
            close(got, want, 2e-5)
        else:
            within_one_ulp(got, want)

    @pytest.mark.parametrize("d,heads", [(128, 2), (768, 12), (200, 2), (64, 1)])
    def test_hgrid_operands_are_main_s(self, attn_variants, d, heads):
        """``benchmarks_torch/tp_slot_split.py::hgrid_operands`` (the smoke's
        and the split's KB (a) 6 operands) builds KB (a) 6's arguments as the
        JAX script's main() does, from its ``prescale_qkv``: bit for bit."""
        import jax.numpy as jnp

        spec = importlib.util.spec_from_file_location(
            "tp_slot_split", REPO / "benchmarks_torch" / "tp_slot_split.py")
        split = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(split)
        a = _hgrid_inputs("float32", d=d, heads=heads, seed=d)
        attn = tuple(torch.from_numpy(a[k]) for k in ("lns", "lnb", "wqkv", "bqkv", "wo_h", "bo"))
        ls, lb, wqkv_h, bqkv_h, wo, bo = split.hgrid_operands(attn, heads)
        hd = d // heads
        wq, bq = attn_variants.prescale_qkv(jnp.asarray(a["wqkv"]), jnp.asarray(a["bqkv"]), d,
                                            heads)
        want_w = jnp.stack([jnp.concatenate([wq[:, i * d + h * hd:i * d + (h + 1) * hd]
                                             for i in range(3)], axis=1)
                            for h in range(heads)]).astype(jnp.bfloat16)
        want_b = jnp.stack([jnp.concatenate([bq[i * d + h * hd:i * d + (h + 1) * hd]
                                             for i in range(3)]) for h in range(heads)])
        assert wqkv_h.dtype == torch.bfloat16 and wo.dtype == torch.bfloat16
        assert torch.equal(wqkv_h.float(),
                           torch.from_numpy(np.asarray(want_w.astype(jnp.float32))))
        assert torch.equal(bqkv_h, torch.from_numpy(np.asarray(want_b)))
        assert torch.equal(wo, attn[4].to(torch.bfloat16))
        assert ls is attn[0] and lb is attn[1] and bo is attn[5]

    def test_hgrid_is_k1_at_float32(self):
        """Pre-scaled q with exp2 and the normalisation after P @ V is K1's
        function: the same block at float32 to f32 rounding."""
        a = _hgrid_inputs("float32", heads=2)
        t = {k: torch.from_numpy(v) for k, v in a.items() if isinstance(v, np.ndarray)}
        hg = fb.attention_block_hgrid(t["x"], t["lns"], t["lnb"], t["wqkv_h"], t["bqkv_h"],
                                      t["wo_h"], t["bo"], heads=2)
        k1 = fb.attention_block_plain(t["x"], t["lns"], t["lnb"], t["wqkv"], t["bqkv"],
                                      t["wo_h"], t["bo"], heads=2)
        close(hg, k1, 2e-5)

    @pytest.mark.parametrize("g", [1, 2])
    def test_head_group_partials_sum_to_the_block(self, g):
        a = _hgrid_inputs("float32", heads=4, d=128)
        t = {k: torch.from_numpy(v) for k, v in a.items() if isinstance(v, np.ndarray)}
        args = (t["x"], t["lns"], t["lnb"], t["wqkv_h"], t["bqkv_h"], t["wo_h"], t["bo"])
        parts = [fb.attention_block_hgrid(*args, heads=4, h0=h0, g=g) for h0 in range(0, 4, g)]
        assert parts[0].dtype == torch.float32
        whole = fb.attention_block_hgrid(*args, heads=4)
        close(fb.tp_reduce(parts, t["bo"], t["x"], bias_first=True), whole, 2e-5)

    def test_head_group_outside_the_heads_raises(self):
        a = _hgrid_inputs("float32")
        t = {k: torch.from_numpy(v) for k, v in a.items() if isinstance(v, np.ndarray)}
        with pytest.raises(ValueError, match="outside 2 heads"):
            fb.attention_block_hgrid(t["x"], t["lns"], t["lnb"], t["wqkv_h"], t["bqkv_h"],
                                     t["wo_h"], t["bo"], heads=2, h0=1, g=2)


# ---------------------------------------------------------------------------
# The dryrun step: one float32 adversary + prompt step on a placed CLIP
# ---------------------------------------------------------------------------


def dryrun_step(model, seed=0, b=8):
    """__graft_entry__.dryrun_multichip's step on the port: frozen image
    embeddings, one Adam step of the adversary on the prompts' similarity
    scores, then the prompt loss (contrastive - adversarial) and its token
    gradient.  Returns (adversary loss, prompt loss, token gradient)."""
    from debias_vision_lang_torch.core.config import TrainConfig
    from debias_vision_lang_torch.models.adversary import Adversary
    from debias_vision_lang_torch.train.adversarial import (clip_contrastive_loss,
                                                            sigmoid_bce, similarity_scores)

    tcfg = TrainConfig()
    rng = np.random.default_rng(seed)
    imgs = torch.from_numpy(rng.normal(size=(b, 32, 32, 3)).astype(np.float32))
    cap_imgs = torch.from_numpy(rng.normal(size=(b, 32, 32, 3)).astype(np.float32))
    labels = torch.from_numpy((rng.random(b) < 0.5).astype(np.float32))
    cap_toks = tokens(b, seed=seed + 1)
    sens = tokens(4, seed=seed + 2)
    adv = Adversary.from_cfg({"ADV_N_INPUT": 4, "ADV_N_OUTPUT": 1, "ADV_HIDDEN_SIZE": 8,
                              "SEED": 2})
    with torch.no_grad():
        img = model.encode_image(imgs).float()
        cap = model.encode_image(cap_imgs).float()
    scale = model.logit_scale.detach()
    opt = torch.optim.Adam(adv.parameters(), lr=tcfg.adversary_lr)
    with torch.no_grad():
        sens_embs = model.encode_text(sens)
    adv_loss = sigmoid_bce(adv(similarity_scores(img, sens_embs, scale))[:, 0], labels)
    opt.zero_grad()
    adv_loss.backward()
    opt.step()
    scores = similarity_scores(img, model.encode_text(sens), scale)
    a = sigmoid_bce(adv(scores)[:, 0], labels)
    c = clip_contrastive_loss(cap, model.encode_text(cap_toks), scale)
    loss = tcfg.contrastive_weight * c - tcfg.adversarial_weight * a
    (grad,) = torch.autograd.grad(loss, model.debias_tokens)
    return adv_loss.item(), loss.item(), grad


def test_dryrun_step_token_gradient_matches_unsharded():
    clip = port_clip(tiny_cfg())
    toks = torch.randn(2, 32, generator=torch.Generator().manual_seed(1)) * 0.02
    model = DebiasCLIP(clip, toks, DebiasConfig(num_debias_tokens=2, hidden_dim=32,
                                                max_tokens=16))
    for p in model.clip.parameters():
        p.requires_grad_(False)
    placed = pm.shard_clip_params(model, cpu_mesh(2, 2))
    a1, l1, g1 = dryrun_step(model)
    a2, l2, g2 = dryrun_step(placed)
    assert abs(a1 - a2) <= 1e-6 and abs(l1 - l2) <= 1e-6
    assert g1.abs().max() > 0
    close(g2, g1, 1e-5 * g1.abs().max().item())


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


class TestRefusals:
    def test_heads_that_do_not_divide_raise(self):
        """Heads that do not divide over the model axis: JAX places them (it
        splits wqkv's columns, not heads), so the port places them too, in
        uneven head groups (two of the four slots hold no head here), and
        computes the unsharded function: float32 within 1e-5, int8 bit-equal."""
        clip = port_clip(tiny_cfg(heads=2))
        placed = pm.shard_clip_params(clip, cpu_mesh(1, 4))
        assert [s.g for s in placed.visual.resblocks[0].slots] == [0, 1, 0, 1]
        q = QuantizedCLIP(clip)
        q_tp = pm.shard_quantized_clip(q, cpu_mesh(2, 4))
        with torch.no_grad():
            close(placed.encode_image(images()), clip.encode_image(images()), 1e-5)
            assert torch.equal(q_tp.encode_image(images(), dtype=torch.float32),
                               q.encode_image(images(), dtype=torch.float32))

    @pytest.mark.parametrize("d,heads,f,m,what", [
        (63, 3, 252, 2, r"D=63 \(H=3\) % 2"), (64, 8, 100, 8, r"F=100 \(D=64\) % 8"),
        (64, 4, 256, 9, r"D=64 \(H=4\) % 9")])
    def test_check_split_names_the_shape(self, d, heads, f, m, what):
        with pytest.raises(ValueError, match=what):
            tpar.check_split(d, heads, f, m)

    def test_unknown_route_raises(self):
        clip = port_clip(tiny_cfg())
        placed = pm.shard_clip_params(clip, cpu_mesh(1, 2))
        with pytest.raises(ValueError, match="route must be one of"):
            placed.visual.resblocks.run(torch.zeros(1, 17, 64), route="xla")


# ---------------------------------------------------------------------------
# The kernels' sources: the build digest sees every changed file
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("edited,libs", [
    ("attention_wgmma.cuh", ("fused_block", "fused_block_q", "attention")),
    ("attention_long.cuh", ("fused_block", "fused_block_q", "attention")),
    ("fused_block.cu", ("fused_block",)), ("fused_block_q.cu", ("fused_block_q",))])
def test_build_digest_follows_the_tp_sources(tmp_path, edited, libs):
    from debias_vision_lang_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    flags = _build.nvcc_flags(csrc)
    names = ("fused_block", "fused_block_q", "attention")
    before = {n: _build.source_digest(csrc, n, flags) for n in names}
    with open(csrc / edited, "a") as fh:
        fh.write("\n// edited\n")
    after = {n: _build.source_digest(csrc, n, flags) for n in names}
    assert {n for n in names if before[n] != after[n]} == set(libs)


def test_the_sources_hold_the_split_entries():
    src = (REPO / "debias_vision_lang_torch" / "csrc")
    bf = (src / "fused_block.cu").read_text()
    q = (src / "fused_block_q.cu").read_text()
    for name in ("dvl_attention_block_heads", "dvl_mlp_block_cols", "dvl_tp_reduce",
                 "EPI_F32"):
        assert name in bf, name
    for name in ("dvl_attention_block_q_heads", "dvl_mlp_block_q_cols", "dvl_rows_q_partial",
                 "dvl_tp_reduce_q", "EQ_I32", "row_amax_kernel",
                 "quant_rows_given_amax_kernel"):
        assert name in q, name
    assert "benchmarks/attn_variants.py" in bf


# ---------------------------------------------------------------------------
# CUDA: the split kernels against their twins on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled with nvcc for sm_90a "
                    "and have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cuda_block(d, dev, seed=3):
    p = _block_np(np.random.default_rng(seed), d, 4 * d)
    return {k: tuple(t.to(dev) for t in v) for k, v in p.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,heads,m,causal", [
    (4, 197, 768, 12, 1, False), (4, 197, 768, 12, 2, False), (4, 197, 768, 12, 4, False),
    (5, 77, 512, 8, 2, True), (5, 77, 512, 8, 4, True), (2, 400, 768, 12, 2, False)])
def test_cuda_split_entries_match_twins(cuda, b, s, d, heads, m, causal):
    p = _cuda_block(d, cuda)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(b, s, d))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    blk = _resblock({k: tuple(t.cpu() for t in v) for k, v in p.items()}).to(cuda)
    tp = tpar.TensorParallelBlocks(torch.nn.ModuleList([blk]), pm.create_mesh(
        (1, m), devices=[cuda] * m), heads)
    fb.reset_launches()
    parts, twins = [], []
    for sh in tp[0].slots:
        args = (x, *p["ln_1"], sh.wqkv, sh.bqkv, sh.wo)
        parts.append(fb.attention_block_heads(*args, heads=heads // m, causal=causal))
        twins.append(fb.attention_block_heads_plain(*args, heads=heads // m, causal=causal))
    torch.cuda.synchronize()
    key = "attention_block_heads_causal" if causal else "attention_block_heads"
    assert fb.TP_LAUNCHES[key] == m and sum(fb.LAUNCHES.values()) == 0
    for got, want in zip(parts, twins):
        within_one_ulp(got, want)
    y = fb.tp_reduce(parts, p["attn"][3], x, bias_first=False)
    assert torch.equal(y, fb.tp_reduce_plain(parts, p["attn"][3], x, bias_first=False))
    within_one_ulp(y, fb.attention_block(x, *p["ln_1"], *p["attn"], heads=heads, causal=causal))
    for sh in tp[0].slots:
        args = (y, *p["ln_2"], sh.w1, sh.b1, sh.w2)
        within_one_ulp(fb.mlp_block_cols(*args), fb.mlp_block_cols_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("s,g", [(197, 12), (197, 6), (197, 3), (400, 6)])
def test_cuda_hgrid_matches_twin(cuda, s, g):
    a = _hgrid_inputs("bfloat16", b=4, s=s, d=768, heads=12, seed=5)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in a.items() if isinstance(v, np.ndarray)}
    x = t["x"].to(torch.bfloat16)
    args = (x, t["lns"], t["lnb"], t["wqkv_h"].to(torch.bfloat16), t["bqkv_h"],
            t["wo_h"].to(torch.bfloat16), t["bo"])
    fb.reset_launches()
    got = fb.attention_block_hgrid(*args, heads=12, h0=12 - g, g=g)
    torch.cuda.synchronize()
    assert fb.TP_LAUNCHES["attention_block_hgrid"] == 1
    within_one_ulp(got, fb.attention_block_hgrid_plain(*args, heads=12, h0=12 - g, g=g))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,heads,m,causal", [
    (4, 197, 768, 12, 2, False), (4, 197, 768, 12, 4, False), (5, 77, 512, 8, 4, True),
    (2, 785, 768, 12, 2, False)])
def test_cuda_int8_split_block_bit_equal_to_k3_k4(cuda, b, s, d, heads, m, causal):
    from debias_vision_lang_torch.ops import quant

    blk = _resblock({k: tuple(t.cpu() for t in v)
                     for k, v in _cuda_block(d, cuda).items()}).to(cuda)
    qb = quant.QuantBlock(blk)
    tp = tpar.TensorParallelQBlocks(torch.nn.ModuleList([qb]), pm.create_mesh(
        (1, m), devices=[cuda] * m), heads)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(b, s, d))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    fbq.reset_launches()
    got = tp.block(0, x, route="fused", causal=causal)
    torch.cuda.synchronize()
    tp_counts = dict(fbq.TP_LAUNCHES)
    assert sum(fbq.LAUNCHES.values()) == 0
    want = fbq.fused_resblock_q(qb, x, heads, causal=causal)
    assert tp_counts["mlp_block_q_cols"] == m and tp_counts["tp_reduce_q"] == 2
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()
    # each slot's codes are the twin quantizer's on the kernel's own rows
    sh = tp[0].slots[0]
    attn, amax = fbq.attention_block_q_heads(x, qb.ln_1.scale, qb.ln_1.bias, sh.wqkv.q,
                                             sh.wqkv.scale, sh.bqkv, heads=heads // m,
                                             causal=causal, wqkv_qt=sh.wqkv.qt)
    assert torch.equal(amax, fbq.row_amax(attn))
    acc, aq, sc = fbq.rows_q_partial(attn, [amax], sh.wo.q, w_qt=sh.wo.qt)
    acc2, aq2, sc2 = fbq.rows_q_partial_plain(attn, [amax], sh.wo.q)
    assert torch.equal(aq, aq2) and torch.equal(sc, sc2) and torch.equal(acc, acc2)


@pytest.mark.cuda
def test_cuda_int8_split_entries_make_missing_kmajor_copies(cuda):
    """Without ``*_qt`` the int8 split entries transpose the weight slice
    themselves, and give what they give with the copy."""
    from debias_vision_lang_torch.ops import quant

    d, heads, m = 768, 12, 2
    blk = _resblock({k: tuple(t.cpu() for t in v)
                     for k, v in _cuda_block(d, cuda).items()}).to(cuda)
    tp = tpar.TensorParallelQBlocks(torch.nn.ModuleList([quant.QuantBlock(blk)]),
                                    pm.create_mesh((1, m), devices=[cuda] * m), heads)
    sh = tp[0].slots[0]
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(2, 197, d))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    ln_s, ln_b = blk.ln_1.scale, blk.ln_1.bias
    a_args = (x, ln_s, ln_b, sh.wqkv.q, sh.wqkv.scale, sh.bqkv)
    got = fbq.attention_block_q_heads(*a_args, heads=heads // m)
    want = fbq.attention_block_q_heads(*a_args, heads=heads // m, wqkv_qt=sh.wqkv.qt)
    assert all(map(torch.equal, got, want))
    m_args = (x, blk.ln_2.scale, blk.ln_2.bias, sh.w1.q, sh.w1.scale, sh.b1)
    assert all(map(torch.equal, fbq.mlp_block_q_cols(*m_args),
                   fbq.mlp_block_q_cols(*m_args, w1_qt=sh.w1.qt)))
    assert all(map(torch.equal, fbq.rows_q_partial(got[0], [got[1]], sh.wo.q),
                   fbq.rows_q_partial(got[0], [got[1]], sh.wo.q, w_qt=sh.wo.qt)))
