"""The int8 rung of the PyTorch port (debias_vision_lang_torch/ops/quant.py)
against the JAX package's ops/quant.py, on the CPU at a tiny size.

The same numpy weights and inputs go through both packages.  Bars:
  * ``quantize_weight`` / ``quantize_resblocks``: bit-exact in q and scale,
    an all-zero column (the 1e-8 clamp) and exact .5 ties included;
  * ``patch_embed_q_p8``: bit-exact, and integer-exact against a float64
    product; ``patch_embed_q``: within one bf16 ulp of the output;
  * the plain int8 layers (``int8_matmul``, ``resblock_q``,
    ``transformer_q(fused=False)``) against JAX's XLA int8 path at float32,
    atol 5e-3 (the JAX package's own bar, tests/test_fused_block_q.py);
  * the int8 towers (``QuantizedCLIP``): cosine >= 0.999;
  * the refusals name their ROADMAP items; the kernel build's digest covers
    the shared headers;
  * the "auto" rung: ``resolve_rung`` equal to JAX's for every registry arch
    (at tiny widths) and bundle type; ``measure_bias`` (ViT, ResNet,
    Frozen-in-Time), zero-shot, the serving engine and the CLI at "auto"
    bit-equal to the rung it resolves to; the patch-staging gate and the
    embedding-cache key see that rung; the float32 hint only on a card and
    only when the dtype was left out.
"""

import dataclasses
import json
import os
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debias_vision_lang_tpu.core.config import (CLIPConfig, DebiasConfig,
                                                TextConfig, VisionConfig)
from debias_vision_lang_tpu.ops import quant as jquant
from debias_vision_lang_torch.models import clip as tclip
from debias_vision_lang_torch.models.convert import params_from_jax, to_jax_tree
from debias_vision_lang_torch.models.debias import DebiasCLIP as TDebiasCLIP
from debias_vision_lang_torch.models.layers import causal_mask as causal_mask_t
from debias_vision_lang_torch.ops import _build
from debias_vision_lang_torch.ops import fused_block_q as fbq
from debias_vision_lang_torch.ops import quant
from debias_vision_lang_torch.vision.preprocess import patchify_u8
from torch_port_config import port_config

torch.set_num_threads(1)

CFG = CLIPConfig(
    name="tiny",
    vision=VisionConfig(kind="vit", image_size=32, patch_size=8, width=64,
                        layers=2, heads=2, embed_dim=32),
    text=TextConfig(vocab_size=512, context_length=16, width=32, layers=2,
                    heads=2, embed_dim=32))
XLA_INT8_ATOL = 5e-3
TCFG = port_config(CFG)  # the port's own config object, same fields


@pytest.fixture(scope="module")
def pair():
    """(JAX params, port CLIP) holding the same weights, every bias and
    LayerNorm non-trivial."""
    rng = np.random.default_rng(0)
    np_params = jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        to_jax_tree(tclip.init_clip_params(TCFG, torch.Generator().manual_seed(0))))
    model = tclip.CLIP(TCFG)
    model.load_state_dict(params_from_jax(np_params, TCFG))
    return jax.tree.map(jnp.asarray, np_params), model


@pytest.fixture(scope="module")
def debias_pair(pair):
    """(JAX DebiasCLIP, port DebiasCLIP) over the same CLIP, 2 prepended
    prompt tokens."""
    from debias_vision_lang_tpu.models.debias import DebiasCLIP as JDebiasCLIP

    jp, model = pair
    deb = np.random.default_rng(5).normal(size=(2, 32)).astype(np.float32)
    dcfg = DebiasConfig(num_debias_tokens=2, hidden_dim=32)
    jm = JDebiasCLIP(clip_params=jp, debias_tokens=jnp.asarray(deb), clip_cfg=CFG,
                     debias_cfg=dcfg)
    return jm, TDebiasCLIP(model, torch.from_numpy(deb), port_config(dcfg))


def _tokens(rng, b=4, s=16, vocab=512):
    ids = rng.integers(1, vocab - 2, size=(b, s))
    for i, e in enumerate(rng.integers(2, s - 3, size=b)):
        ids[i, 0], ids[i, e], ids[i, e + 1:] = vocab - 2, vocab - 1, 0
    return ids.astype(np.int64)


def _np(t):
    return np.asarray(t.detach().float() if torch.is_tensor(t) else t, np.float32)


def _cos_rows(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _within_one_ulp(got, ref):
    got, ref = _np(got), _np(ref)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    err = np.abs(got - ref).max()
    assert err <= ulp, f"max err {err} > 1 bf16 ulp {ulp}"


def _weight(rng, shape):
    """Gaussian weights with an all-zero output column and, in column 1,
    amax 127 (scale exactly 1) over exact .5 ties of both signs."""
    w = rng.normal(size=shape).astype(np.float32)
    w[..., :, 0] = 0.0
    ties = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -2.5, 126.5], np.float32)
    w[..., : len(ties), 1] = ties
    return w


class TestQuantizeWeight:
    @pytest.mark.parametrize("shape", [(8, 16), (3, 32, 96), (64, 13)])
    def test_bit_exact_against_jax(self, shape):
        w = _weight(np.random.default_rng(len(shape) * 100 + shape[-1]), shape)
        want = jquant.quantize_weight(jnp.asarray(w))
        got = quant.quantize_weight(torch.from_numpy(w))
        assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
        assert tuple(got["scale"].shape) == tuple(want["scale"].shape)
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
        np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))

    def test_zero_column_and_ties(self):
        got = quant.quantize_weight(torch.from_numpy(_weight(np.random.default_rng(1),
                                                             (8, 4))))
        assert float(got["scale"][0, 0]) == np.float32(1e-8)
        assert (got["q"][:, 0] == 0).all()
        assert float(got["scale"][0, 1]) == 1.0  # 127 / 127
        # round half to even: 2.5 -> 2, -3.5 -> -4, 0.5 -> 0, 1.5 -> 2, 126.5 -> 126
        assert got["q"][:, 1].tolist() == [127, 2, -4, 0, 0, 2, -2, 126]

    def test_qweight_layout(self):
        w = torch.from_numpy(np.random.default_rng(2).normal(size=(32, 48)).astype(np.float32))
        qw = quant.QWeight(w)
        assert qw.q.shape == (32, 48) and qw.scale.shape == (1, 48)
        assert qw.qt.shape == (48, 32) and qw.qt.is_contiguous()
        assert torch.equal(qw.qt, qw.q.t())
        assert {n for n, _ in qw.named_buffers()} == {"q", "scale", "qt"}

    @pytest.mark.parametrize("tower", ["visual", "text"])
    def test_resblocks_from_params_from_jax(self, pair, tower):
        """The int8 tree derived from the bridged float parameters is JAX's
        ``quantize_resblocks`` of the same tree, bit for bit."""
        jp, model = pair
        want = jquant.quantize_resblocks(jp[tower]["resblocks"])
        got = quant.quantize_resblocks(getattr(model, tower).resblocks)
        for name, group in (("wqkv", "attn"), ("wo", "attn"), ("w1", "mlp"), ("w2", "mlp")):
            for part in ("q", "scale"):
                stacked = np.stack([getattr(getattr(blk, name), part).numpy()
                                    for blk in got])
                np.testing.assert_array_equal(stacked, np.asarray(want[group][name][part]))
        # the float parts are the block's own parameters, not copies
        assert got[0].ln_1.scale is getattr(model, tower).resblocks[0].ln_1.scale
        assert got[1].b2 is getattr(model, tower).resblocks[1].mlp.b2


class TestStems:
    @pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("k", [192, 588])  # patch 8; ViT-L/14's patch 14
    def test_patch_embed_q_p8_bit_exact(self, out_dtype, k):
        rng = np.random.default_rng(3)
        u8 = rng.integers(0, 256, (3, 16, k), dtype=np.uint8)
        w = (rng.normal(size=(k, 64)) * 0.01).astype(np.float32)
        bias = rng.normal(size=(64,)).astype(np.float32)
        want = jquant.patch_embed_q_p8(jnp.asarray(u8), jquant.quantize_weight(jnp.asarray(w)),
                                       jnp.asarray(bias), out_dtype=getattr(jnp, out_dtype))
        qw = quant.QWeight(torch.from_numpy(w))
        got = quant.patch_embed_q_p8(torch.from_numpy(u8), qw, torch.from_numpy(bias),
                                     out_dtype=getattr(torch, out_dtype))
        assert got.dtype == getattr(torch, out_dtype)
        np.testing.assert_array_equal(_np(got), _np(np.asarray(want, np.float32)))

    def test_patch_embed_q_p8_is_integer_exact(self):
        """acc + 128 colsum(q) is u8 @ q exactly: the only error left is the
        weight rounding."""
        rng = np.random.default_rng(4)
        u8 = rng.integers(0, 256, (2, 16, 192), dtype=np.uint8)
        qw = quant.QWeight(torch.from_numpy(rng.normal(size=(192, 64)).astype(np.float32)))
        got = quant.patch_embed_q_p8(torch.from_numpy(u8), qw, out_dtype=torch.float64)
        exact = (torch.from_numpy(u8).double() @ qw.q.double()) * qw.scale.double()[0]
        # float64 of (int32 product as f32) * f32 scale: f32 rounding of each
        np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=2 ** -23)
        ints = torch.from_numpy(u8).double() @ qw.q.double()
        assert ints.abs().max() < 2 ** 24  # f32-exact, so only the scale rounds

    def test_patch_embed_q_within_one_ulp(self):
        rng = np.random.default_rng(5)
        images = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
        w = (rng.normal(size=(192, 64)) * 0.05).astype(np.float32)
        want = jquant.patch_embed_q(jnp.asarray(images), 8,
                                    jquant.quantize_weight(jnp.asarray(w)))
        got = quant.patch_embed_q(torch.from_numpy(images), 8, quant.QWeight(torch.from_numpy(w)))
        assert got.dtype == torch.bfloat16 and got.shape == (2, 16, 64)
        _within_one_ulp(got, np.asarray(want, np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(9, 588), (600, 588), (600, 768)])
def test_int_mm_on_the_card_equals_the_cpu_product(m, k):
    """cuBLAS's int8 GEMM takes K in multiples of 8 only: ``int_mm`` pads
    ViT-L/14's K = 588 (and an M of at most 16) with zeros, exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: cuBLAS's int8 GEMM")
    g = torch.Generator().manual_seed(k)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = quant.QWeight(torch.randn(k, 64, generator=g))
    want = torch._int_mm(a, w.q)
    got = fbq.int_mm(a.cuda(), w.q.cuda(), w.qt.cuda())
    assert torch.equal(got.cpu(), want)


class TestPlainInt8Path:
    @pytest.mark.parametrize("with_bias", [False, True])
    def test_int8_matmul(self, with_bias):
        rng = np.random.default_rng(6)
        x = rng.normal(size=(3, 5, 32)).astype(np.float32)
        w = rng.normal(size=(32, 24)).astype(np.float32)
        b = rng.normal(size=(24,)).astype(np.float32) if with_bias else None
        want = jquant.int8_matmul(jnp.asarray(x), jquant.quantize_weight(jnp.asarray(w)),
                                  None if b is None else jnp.asarray(b))
        got = quant.int8_matmul(torch.from_numpy(x), quant.QWeight(torch.from_numpy(w)),
                                None if b is None else torch.from_numpy(b))
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)

    @pytest.mark.parametrize("causal", [False, True])
    def test_resblock_q(self, pair, causal):
        from debias_vision_lang_tpu.models.layers import causal_mask

        jp, model = pair
        x = np.random.default_rng(7).normal(size=(3, 13, 64)).astype(np.float32)
        layer0 = jax.tree.map(lambda a: a[0],
                              jquant.quantize_resblocks(jp["visual"]["resblocks"]))
        want = jquant.resblock_q(layer0, jnp.asarray(x), 2,
                                 mask=causal_mask(13) if causal else None)
        blk = quant.quantize_resblocks(model.visual.resblocks)[0]
        got = quant.resblock_q(blk, torch.from_numpy(x), 2,
                               mask=causal_mask_t(13) if causal else None)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=XLA_INT8_ATOL)

    @pytest.mark.parametrize("causal", [False, True])
    def test_transformer_q_plain(self, pair, causal):
        jp, model = pair
        x = np.random.default_rng(8).normal(size=(2, 13, 64)).astype(np.float32)
        want = jquant.transformer_q(jquant.quantize_resblocks(jp["visual"]["resblocks"]),
                                    jnp.asarray(x), 2, fused=False, causal=causal)
        got = quant.transformer_q(quant.quantize_resblocks(model.visual.resblocks),
                                  torch.from_numpy(x), 2, fused=False, causal=causal)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=XLA_INT8_ATOL)

    def test_fused_twins_close_to_plain(self, pair):
        """The fused route (twins on the CPU) and the plain int8 layers
        quantize the same rows; they differ in fp op order only."""
        _, model = pair
        blocks = quant.quantize_resblocks(model.visual.resblocks)
        x = torch.from_numpy(np.random.default_rng(9).normal(size=(2, 13, 64))
                             .astype(np.float32))
        fused = quant.transformer_q(blocks, x, 2, fused=True)
        plain = quant.transformer_q(blocks, x, 2, fused=False)
        np.testing.assert_allclose(_np(fused), _np(plain), atol=XLA_INT8_ATOL)


class TestTowers:
    def test_encode_image_vit_q_p8_matches_jax(self, pair):
        jp, model = pair
        from debias_vision_lang_tpu.models.loader import CLIP as JCLIP

        u8 = np.random.default_rng(10).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
        p8 = patchify_u8(u8, 8)
        want = jquant.QuantizedCLIP(JCLIP(params=jp, cfg=CFG)).encode_image(jnp.asarray(p8))
        qm = quant.QuantizedCLIP(model)
        got = qm.encode_image(torch.from_numpy(p8))
        assert got.dtype == torch.bfloat16 and got.shape == (3, 32)
        assert _cos_rows(_np(got), np.asarray(want, np.float32)).min() >= 0.999
        # and against the port's own float32 tower
        ref32 = model.encode_image(torch.from_numpy(p8), dtype=torch.float32)
        assert _cos_rows(_np(got), _np(ref32)).min() >= 0.999

    def test_encode_image_vit_q_from_float_images(self, pair):
        jp, model = pair
        from debias_vision_lang_tpu.models.loader import CLIP as JCLIP

        x = np.random.default_rng(11).normal(size=(2, 32, 32, 3)).astype(np.float32)
        want = jquant.QuantizedCLIP(JCLIP(params=jp, cfg=CFG)).encode_image(jnp.asarray(x))
        got = quant.QuantizedCLIP(model).encode_image(torch.from_numpy(x))
        assert _cos_rows(_np(got), np.asarray(want, np.float32)).min() >= 0.999

    def test_encode_text_q_debias_matches_jax(self, debias_pair):
        jm, tm = debias_pair
        ids = _tokens(np.random.default_rng(12))
        want = jquant.QuantizedCLIP(jm, quantize_text=True).encode_text(jnp.asarray(ids))
        got = quant.QuantizedCLIP(tm, quantize_text=True).encode_text(torch.from_numpy(ids))
        assert got.dtype == torch.bfloat16
        assert _cos_rows(_np(got), np.asarray(want, np.float32)).min() >= 0.999
        ref32 = tm.encode_text(torch.from_numpy(ids))
        assert _cos_rows(_np(got), _np(ref32)).min() >= 0.999

    def test_encode_text_q_bare_clip_matches_jax(self, pair):
        jp, model = pair
        from debias_vision_lang_tpu.models.loader import CLIP as JCLIP

        ids = _tokens(np.random.default_rng(13))
        want = jquant.QuantizedCLIP(JCLIP(params=jp, cfg=CFG),
                                    quantize_text=True).encode_text(jnp.asarray(ids))
        got = quant.QuantizedCLIP(model, quantize_text=True).encode_text(torch.from_numpy(ids))
        assert _cos_rows(_np(got), np.asarray(want, np.float32)).min() >= 0.999

    def test_text_stays_float_without_int8_text(self, debias_pair):
        _, tm = debias_pair
        ids = torch.from_numpy(_tokens(np.random.default_rng(14)))
        qm = quant.QuantizedCLIP(tm)
        assert qm.text_q is None
        torch.testing.assert_close(qm.encode_text(ids), tm.encode_text(ids), rtol=0, atol=0)

    def test_fused_route_counts_nothing_on_cpu(self, pair, monkeypatch):
        _, model = pair
        calls = []
        orig = fbq.attention_block_q
        monkeypatch.setattr(fbq, "attention_block_q",
                            lambda *a, **k: calls.append(k["causal"]) or orig(*a, **k))
        fbq.reset_launches()
        p8 = torch.from_numpy(patchify_u8(
            np.random.default_rng(15).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8), 8))
        quant.QuantizedCLIP(model).encode_image(p8)
        assert calls == [False] * CFG.vision.layers  # bf16 -> the fused twins
        quant.QuantizedCLIP(model).encode_image(p8, dtype=torch.float32)
        assert len(calls) == CFG.vision.layers  # float32 -> the plain int8 layers
        assert all(v == 0 for v in fbq.LAUNCHES.values())


class TestLadder:
    def test_non_vit_tower_raises_naming_roadmap(self):
        cfg = CLIPConfig(name="swin", vision=VisionConfig(kind="swin", image_size=32,
                                                          patch_size=8, width=64, layers=1,
                                                          heads=1, embed_dim=32),
                         text=CFG.text)
        cfg = port_config(cfg)
        with pytest.raises(NotImplementedError, match="the port builds .*video_vit"):
            quant.QuantizedCLIP(types.SimpleNamespace(cfg=cfg))
        with pytest.raises(NotImplementedError, match="the port builds .*video_vit"):
            quant.resolve_compute(types.SimpleNamespace(cfg=cfg), "int8")

    def test_resnet_tower_takes_the_int8_rung(self):
        from debias_vision_lang_torch.ops.quant_resnet import QuantResNet

        cfg = port_config(CLIPConfig(
            name="rn", vision=VisionConfig(kind="resnet", image_size=64, patch_size=32,
                                           width=16, layers=(1, 1, 1, 1), heads=8,
                                           embed_dim=32), text=CFG.text))
        model = tclip.CLIP(cfg)
        model.load_state_dict(tclip.init_clip_params(cfg))
        with pytest.warns(UserWarning, match="ModifiedResNet"):
            qm, dt = quant.resolve_compute(model, "int8")
        assert isinstance(qm.visual_q, QuantResNet) and dt == torch.bfloat16
        out = qm.encode_image(torch.zeros(1, 64, 64, 3))
        assert out.shape == (1, 32) and torch.isfinite(out.float()).all()

    def test_auto_takes_the_int8_rung(self, pair):
        """A ViT under "auto" is wrapped once, as JAX's resolve_compute does."""
        qm, dt = quant.resolve_compute(pair[1], "auto")
        assert isinstance(qm, quant.QuantizedCLIP) and qm.text_q is None
        assert dt == torch.bfloat16
        assert quant.resolve_compute(qm, "auto")[0] is qm

    def test_unknown_dtype(self, pair):
        with pytest.raises(ValueError, match="unknown dtype"):
            quant.resolve_compute(pair[1], "int4")

    @pytest.mark.parametrize("dtype,text_q", [("int8", False), ("int8-text", True)])
    def test_int8_rungs_wrap_once(self, pair, dtype, text_q):
        qm, dt = quant.resolve_compute(pair[1], dtype)
        assert isinstance(qm, quant.QuantizedCLIP) and dt == torch.bfloat16
        assert (qm.text_q is not None) == text_q
        assert quant.resolve_compute(qm, dtype)[0] is qm  # idempotent
        assert quant.resolve_compute(pair[1], "float32") == (pair[1], torch.float32)

    def test_ambiguous_3d_input_rejected(self, pair):
        qm = quant.QuantizedCLIP(pair[1])
        with pytest.raises(ValueError, match="patch-contiguous staging"):
            qm.encode_image(torch.zeros(2, 16, 192))  # float lookalike


class TestBuildDigest:
    def _tree(self, tmp_path):
        (tmp_path / "a.cu").write_text('#include "common.cuh"\n')
        (tmp_path / "b.cu").write_text('#include "common.cuh"\n')
        (tmp_path / "common.cuh").write_text("// v1\n")
        return tmp_path

    def test_header_edit_changes_digest(self, tmp_path):
        csrc = self._tree(tmp_path)
        flags = _build.nvcc_flags(csrc)
        before = _build.source_digest(csrc, "a", flags)
        assert _build.source_digest(csrc, "a", flags) == before  # stable
        (csrc / "common.cuh").write_text("// v2\n")
        edited = _build.source_digest(csrc, "a", flags)
        assert edited != before
        (csrc / "extra.cuh").write_text("// new header\n")
        assert _build.source_digest(csrc, "a", flags) not in (before, edited)

    def test_long_route_header_is_hashed_into_every_library(self, tmp_path):
        """K1, K3 and K5 share csrc/attention_long.cuh: an edit of it names
        a new fused_block, fused_block_q and attention library."""
        import shutil

        csrc = tmp_path / "csrc"
        shutil.copytree(_build.CSRC, csrc)
        assert (csrc / "attention_long.cuh").exists()
        flags = _build.nvcc_flags(csrc)
        libs = ("fused_block", "fused_block_q", "attention")
        before = {n: _build.source_digest(csrc, n, flags) for n in libs}
        with open(csrc / "attention_long.cuh", "a") as f:
            f.write("// edited\n")
        after = {n: _build.source_digest(csrc, n, flags) for n in libs}
        assert all(after[n] != before[n] for n in libs)

    def test_wgmma_core_header_is_hashed_into_every_library(self, tmp_path):
        """K1, K3 (with the attribution's softmax-off mode) and K5 share
        csrc/attention_wgmma.cuh: an edit of it names new libraries."""
        import shutil

        csrc = tmp_path / "csrc"
        shutil.copytree(_build.CSRC, csrc)
        flags = _build.nvcc_flags(csrc)
        libs = ("fused_block", "fused_block_q", "attention")
        before = {n: _build.source_digest(csrc, n, flags) for n in libs}
        with open(csrc / "attention_wgmma.cuh", "a") as f:
            f.write("// edited\n")
        assert all(_build.source_digest(csrc, n, flags) != before[n] for n in libs)

    def test_sass_checks_name_the_attribution_instantiations(self, monkeypatch):
        """chip_smoke.sass_check_attr finds each instantiation the
        attribution's blocks launch by its mangled name (the s8 GEMM at the
        EpilogueQ values of csrc/fused_block_q.cu, EQ_BIAS_S8 among them, the
        softmax-off wgmma cores, the stubs) and fails on a missing one, on one
        without its wgmma / TMA forms, and on mma.sync."""
        import pathlib
        import re
        import sys

        root = pathlib.Path(__file__).resolve().parent.parent
        sys.path.insert(0, str(root))
        import chip_smoke as C

        cu = (_build.CSRC / "fused_block_q.cu").read_text()
        epi = {n: int(v) for n, v in re.findall(r"\b(EQ_\w+) = (\d+),", cu)}
        gemm = "IGMMA.64x128x32.S32.S8.S8 ; UTMALDG.2D ;"
        funcs = {f"_ZN12_GLOBAL__N_114gemm_s8_kernelILi{epi[e]}EEEv14CUtensorMap_st": gemm
                 for e in ("EQ_BIAS", "EQ_BIAS_RESID", "EQ_RESID_BIAS", "EQ_BIAS_S8")}
        funcs.update({
            "_ZN12_GLOBAL__N_122attention_wgmma_kernelILi200ELi0ELi0EEEv": "HGMMA.64x200x16.F32.BF16 ;",
            "_ZN12_GLOBAL__N_114cast_s8_kernelILb1EEEvPK13__nv_bfloat16": "F2I.TRUNC ;",
            "_ZN12_GLOBAL__N_117bcast_rows_kernelILi0EEEvPKa": "FADD ;",
            "_ZN12_GLOBAL__N_125attention_vpu_core_kernelEPK13__nv_bfloat16": "MUFU.EX2 ;"})
        monkeypatch.setattr(C, "sass_functions", lambda path: dict(funcs))
        C.sass_check_attr("fused_block_q", "lib.so")
        s8 = next(k for k in funcs if f"ILi{epi['EQ_BIAS_S8']}E" in k)
        for broken in ({s8: "UTMALDG.2D ;"}, {s8: gemm + " IMMA.16832.S8.S8 ;"},
                       {s8: None}):
            bad = {k: v for k, v in {**funcs, **broken}.items() if v is not None}
            monkeypatch.setattr(C, "sass_functions", lambda path, bad=bad: bad)
            with pytest.raises(RuntimeError):
                C.sass_check_attr("fused_block_q", "lib.so")

    def test_other_source_and_flags(self, tmp_path):
        csrc = self._tree(tmp_path)
        flags = _build.nvcc_flags(csrc)
        before = _build.source_digest(csrc, "a", flags)
        (csrc / "b.cu").write_text("// another kernel\n")
        assert _build.source_digest(csrc, "a", flags) == before
        assert _build.source_digest(csrc, "a", flags + ["-G"]) != before
        assert flags[-2:] == ["-I", str(csrc)]


# ---------------------------------------------------------------------------
# The "auto" rung
# ---------------------------------------------------------------------------

from debias_vision_lang_tpu.core.registry import VALID_MODELS  # noqa: E402

PROMPTS = ["a good person", "a bad person", "a photo of a doctor", "a criminal"]
_TINY = {}


def tiny_arch(name):
    """The registry arch ``name`` at tiny widths, its tower kind (and, for
    Frozen-in-Time, its image statistics) kept."""
    from debias_vision_lang_tpu.core.registry import resolve_arch as jresolve

    full = jresolve(name)
    if full.vision.kind == "resnet":
        vision = VisionConfig(kind="resnet", image_size=64, patch_size=32, width=16,
                              layers=(1, 1, 1, 1), heads=8, embed_dim=32)
    else:
        vision = dataclasses.replace(full.vision, image_size=32, patch_size=8, width=64,
                                     layers=1, heads=2, embed_dim=32)
    return CLIPConfig(name=full.name, vision=vision, text=CFG.text)


def tiny_bundles(name):
    """{bundle type: (JAX bundle, port bundle)} of one registry arch at tiny
    widths, from the same JAX-initialised weights."""
    if name in _TINY:
        return _TINY[name]
    from debias_vision_lang_tpu.models import frozen_in_time as jfit
    from debias_vision_lang_tpu.models.clip import init_clip_params as jinit
    from debias_vision_lang_tpu.models.debias import DebiasCLIP as JDebiasCLIP
    from debias_vision_lang_tpu.models.loader import CLIP as JCLIP
    from debias_vision_lang_torch.models import frozen_in_time as tfit

    cfg = tiny_arch(name)
    tcfg = port_config(cfg)
    video = cfg.vision.kind == "video_vit"
    jp = (jfit.init_fit_params(jax.random.key(0), cfg) if video
          else jinit(jax.random.key(0), cfg))
    sd = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    out = {}
    for mode in (("joint", "divided") if video else (None,)):
        if video:
            jb, tb = jfit.FrozenInTime(params=jp, cfg=cfg, attention=mode), \
                tfit.FrozenInTime(tcfg, mode)
        else:
            jb, tb = JCLIP(params=jp, cfg=cfg), tclip.CLIP(tcfg)
        tb.load_state_dict(sd)
        out["clip" if mode in (None, "joint") else "clip-divided"] = (jb, tb)
    jb, tb = out["clip"]
    deb = np.zeros((2, cfg.text.width), np.float32)
    dcfg = DebiasConfig(num_debias_tokens=2, hidden_dim=cfg.text.width)
    out["debias"] = (JDebiasCLIP(clip_params=jp, debias_tokens=jnp.asarray(deb), clip_cfg=cfg,
                                 debias_cfg=dcfg),
                     TDebiasCLIP(tb, torch.from_numpy(deb), port_config(dcfg)))
    out["quantized"] = (jquant.quantize_for_inference(jb)[0], quant.QuantizedCLIP(tb))
    _TINY[name] = out
    return out


RUNG_CASES = [(name, kind) for name in VALID_MODELS
              for kind in ("clip", "debias", "quantized")
              + (("clip-divided",) if name.startswith("m-bain/") else ())]


class TestAutoRung:
    @pytest.mark.parametrize("name,bundle", RUNG_CASES)
    def test_resolve_rung_equals_jax(self, name, bundle):
        jb, tb = tiny_bundles(name)[bundle]
        want = jquant.resolve_rung(jb, "auto")
        assert quant.resolve_rung(tb, "auto") == want
        assert want == ("bfloat16" if "/RN" in name else "int8")
        for rung in ("float32", "bfloat16", "int8", "int8-text"):
            assert quant.resolve_rung(tb, rung) == jquant.resolve_rung(jb, rung) == rung

    def test_custom_cliplike_takes_bfloat16_as_jax(self):
        class Custom:  # no discoverable config
            pass

        c = Custom()
        assert quant.resolve_rung(c, "auto") == jquant.resolve_rung(c, "auto") == "bfloat16"
        model, dt = quant.resolve_compute(c, "auto")
        assert model is c and dt == torch.bfloat16

    def test_resnet_auto_is_bfloat16_without_the_int8_warning(self):
        _, tb = tiny_bundles("openai/CLIP/RN50")["clip"]
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            model, dt = quant.resolve_compute(tb, "auto")
        assert model is tb and dt == torch.bfloat16
        with pytest.warns(UserWarning, match="dtype='auto' to pick the fastest"):
            quant.resolve_compute(tb, "int8")


def _tok(texts):
    out = np.zeros((len(texts), 16), np.int64)
    out[:, 0] = 510
    for i, t in enumerate(texts):
        out[i, 1] = sum(t.encode()) % 400 + 1
        out[i, 2] = 511
    return out


@pytest.fixture(scope="module")
def auto_fairface(tmp_path_factory):
    """12 FairFace val rows of 40 x 32 px images, balanced gender."""
    from test_torch_parallel import write_fairface

    return write_fairface(str(tmp_path_factory.mktemp("auto_ff") / "ff"), n=12)


# (registry arch, the rung "auto" resolves to, measure_bias opts of the case)
MEASURE_CASES = {"vit": ("openai/CLIP/ViT-B/16", "int8"),
                 "resnet": ("openai/CLIP/RN50", "bfloat16"),
                 "fit": ("m-bain/frozen-in-time/base", "int8")}


def _measure_case(case, fairface, video_root):
    from debias_vision_lang_torch.vision.preprocess import Preprocess as TPreprocess

    name, rung = MEASURE_CASES[case]
    _, model = tiny_bundles(name)["debias"]
    cfg = model.clip_cfg.vision
    opts = {"batch_size": 4, "num_workers": 1, "topn": 0.5, "prompts": PROMPTS}
    if case == "fit":
        opts.update(dataset="video", num_frames=4, data_path=video_root)
    else:
        opts.update(data_path=fairface)
    return model, TPreprocess(cfg.image_size), opts, rung


@pytest.fixture(scope="module")
def auto_videos(tmp_path_factory):
    """6 frame directories of 4 PNG frames, 32 px, with a labels.csv."""
    import pandas as pd
    from PIL import Image

    root = tmp_path_factory.mktemp("auto_videos")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(6):
        (root / f"vid{i}").mkdir()
        for f in range(4):
            Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(
                root / f"vid{i}" / f"frame_{f}.png")
        rows.append({"file": f"vid{i}", "gender": "Male" if i % 2 else "Female",
                     "race": "White", "age": "20-29"})
    pd.DataFrame(rows).to_csv(root / "labels.csv", index=False)
    return str(root)


class TestAutoEntryPoints:
    @pytest.mark.parametrize("case", list(MEASURE_CASES))
    def test_measure_bias_auto_is_the_rung_bit_for_bit(self, case, auto_fairface,
                                                       auto_videos, tmp_path, monkeypatch):
        """Metrics, cached embeddings and cache key of "auto" equal the
        explicit rung's; the staging gate sees the rung (patch-contiguous
        for a ViT at int8, NHWC for a ResNet, frames for a video tower)."""
        from debias_vision_lang_torch.eval import measure as tmeasure

        model, pre, opts, rung = _measure_case(case, auto_fairface, auto_videos)
        staged = []
        real = tmeasure.HostLoader

        def spy(*a, **kw):
            staged.append(kw.get("native_patch"))
            return real(*a, **kw)

        monkeypatch.setattr(tmeasure, "HostLoader", spy)
        out = {}
        for dt in ("auto", rung):
            path = str(tmp_path / f"{dt}.npz")
            res = tmeasure.measure_bias(model, pre, _tok, "gender",
                                        opts={**opts, "dtype": dt, "cache_embeddings": path})
            with np.load(path) as f:
                out[dt] = (res, f["embeddings"], str(f["cache_key"]))
        (ra, ea, ka), (rr, er, kr) = out["auto"], out[rung]
        assert ra == rr
        np.testing.assert_array_equal(ea, er)
        assert ka == kr and json.loads(ka)["dtype"] == rung
        assert staged == [8, 8] if case == "vit" else staged == [None, None]

    @pytest.mark.parametrize("case", list(MEASURE_CASES))
    def test_cached_auto_hits_the_rung_s_file(self, case, auto_fairface, auto_videos,
                                              tmp_path, monkeypatch):
        from debias_vision_lang_torch.eval import measure as tmeasure

        model, pre, opts, rung = _measure_case(case, auto_fairface, auto_videos)
        opts = {**opts, "cache_embeddings": str(tmp_path / "emb.npz")}
        want = tmeasure.measure_bias(model, pre, _tok, "gender", opts={**opts, "dtype": rung})

        def no_embed(*a, **k):
            raise AssertionError("the auto run missed the cache")

        monkeypatch.setattr(tmeasure, "get_labels_img_embeddings", no_embed)
        got = tmeasure.measure_bias(model, pre, _tok, "gender", opts={**opts, "dtype": "auto"})
        assert got == want

    def test_zero_shot_auto_is_int8(self, tmp_path):
        from PIL import Image

        from debias_vision_lang_torch.cli import FolderDataset
        from debias_vision_lang_torch.data.loader import HostLoader
        from debias_vision_lang_torch.eval.zero_shot import zero_shot_accuracy

        rng = np.random.default_rng(2)
        for c in ("cat", "dog", "fox"):
            (tmp_path / c).mkdir()
            for i in range(3):
                Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(
                    tmp_path / c / f"{i}.png")
        _, model = tiny_bundles("openai/CLIP/ViT-B/16")["clip"]
        ds = FolderDataset(str(tmp_path))
        got = {dt: zero_shot_accuracy(model, _tok, HostLoader(ds, batch_size=4, native_n_px=32),
                                      ds.class_names, n_px=32, dtype=dt)
               for dt in ("auto", "int8")}
        assert got["auto"] == got["int8"] and got["auto"]["n"] == 9

    def test_engine_auto_is_int8(self):
        from debias_vision_lang_torch.serve.engine import InferenceEngine

        _, model = tiny_bundles("openai/CLIP/ViT-B/16")["clip"]
        imgs = list(np.random.default_rng(3).integers(0, 256, (5, 32, 32, 3), dtype=np.uint8))
        engines = {dt: InferenceEngine(model, None, max_batch=4, compute_dtype=dt, device="cpu")
                   for dt in ("auto", "int8")}
        assert engines["auto"].info()["precision"] == "auto"
        assert engines["auto"].info()["compute_dtype"] == "bfloat16"
        assert engines["auto"]._patch == engines["int8"]._patch == 8
        np.testing.assert_array_equal(engines["auto"].embed_image_arrays(imgs),
                                      engines["int8"].embed_image_arrays(imgs))

    def test_cli_measure_bias_auto_is_the_rung(self, auto_fairface, monkeypatch, capsys):
        from debias_vision_lang_torch import cli as tcli
        from debias_vision_lang_torch.models import loader
        from debias_vision_lang_torch.vision.preprocess import Preprocess as TPreprocess

        _, model = tiny_bundles("openai/CLIP/ViT-B/16")["debias"]
        monkeypatch.setattr(loader, "model_loader",
                            lambda *a, **k: (model, TPreprocess(32), _tok, "tiny"))
        out = {}
        for dt in ("auto", "int8"):
            tcli.main(["measure-bias", "--device", "cpu", "--random-weights", "--dtype", dt,
                       "--data-path", auto_fairface, "--batch-size", "4"])
            out[dt] = capsys.readouterr().out
        assert out["auto"] == out["int8"] and '"ndkl"' in out["auto"]


class TestImplicitFp32Hint:
    """JAX's hint fires on a TPU backend when the float32 default picks
    itself; the port's when the model lives on a card."""

    def test_silent_on_the_cpu(self, pair):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            quant.hint_implicit_fp32("measure_bias", pair[1])

    def test_measure_bias_gate_is_omission_not_value(self, monkeypatch):
        """A model on a card (the device read patched) hints iff opts holds no
        dtype: a typo'd opt stops the call right after the gate."""
        from debias_vision_lang_torch.eval import measure as tmeasure

        monkeypatch.setattr(quant, "_device_type", lambda model: "cuda")
        with pytest.warns(UserWarning, match="dtype='auto'"):
            with pytest.raises(ValueError, match="unknown measure_bias"):
                tmeasure.measure_bias(None, None, None, opts={"topnn": 1})
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            with pytest.raises(ValueError, match="unknown measure_bias"):
                tmeasure.measure_bias(None, None, None, opts={"topnn": 1, "dtype": "float32"})

    def test_zero_shot_gate_is_dtype_none(self, pair, monkeypatch):
        from debias_vision_lang_torch.eval.zero_shot import zero_shot_accuracy

        monkeypatch.setattr(quant, "_device_type", lambda model: "cuda")
        with pytest.warns(UserWarning, match="zero_shot_accuracy: dtype defaulted"):
            with pytest.raises(ValueError, match="yielded no images"):
                zero_shot_accuracy(pair[1], _tok, [], ["a", "b"], n_px=32)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            with pytest.raises(ValueError, match="yielded no images"):
                zero_shot_accuracy(pair[1], _tok, [], ["a", "b"], n_px=32, dtype="float32")

    @pytest.mark.cuda
    def test_fires_for_a_model_on_the_card(self, pair):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the hint reads the model's device")
        import copy

        model = copy.deepcopy(pair[1]).cuda()
        with pytest.warns(UserWarning, match=r"On this card, dtype='auto'"):
            quant.hint_implicit_fp32("measure_bias", model)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            quant.hint_implicit_fp32("measure_bias", pair[1])
