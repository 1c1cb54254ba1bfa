"""The int8 rung of the ModifiedResNet tower (debias_vision_lang_torch/ops/
quant_resnet.py and ``QuantizedCLIP`` over a ResNet) against the JAX
package's ops/quant_resnet.py, on the CPU at a tiny size (the towers of
tests/test_torch_resnet.py, BatchNorms redrawn).

Bars:
  * ``quantize_conv_weight``: q and scale bit-exact, an all-zero channel
    (the 1e-8 clamp) and exact .5 ties included;
  * ``fold_bn``: within 1e-6 relative;
  * ``int8_conv``: the int8 codes, the per-image scales and the int32
    accumulators exact for the same input (the K = 27 stem, stride 2 with
    padding 1, odd sizes), the output within 1e-6 relative;
  * ``encode_image_resnet_q`` at float32: cosine >= 0.99999 against JAX's on
    the same int8 weights, and > 0.99 against the float tower with each
    package's own quantization.  The two quantizations are not held to each
    other: XLA's CPU rsqrt is not correctly rounded, so a folded scale may
    sit one ulp from the port's, and one flipped code cascades through
    every later per-image scale;
  * ``measure_bias(dtype="int8")``: its image rows at cosine >= 0.999
    with JAX's on the same int8 weights (its bfloat16 activations are where
    JAX's own jitted and eager towers part, see the test), its metrics
    equal to the numpy oracle's;
  * a ResNet ``QuantizedCLIP`` never takes a ViT stem, and
    ``resolve_compute`` warns on an explicit int8 rung, naming no TPU
    figure.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debias_vision_lang_tpu.models import resnet as jres
from debias_vision_lang_tpu.ops import quant_resnet as jqr
from debias_vision_lang_torch.ops import fused_block_q as fbq
from debias_vision_lang_torch.ops import quant as tquant
from debias_vision_lang_torch.ops import quant_resnet as tqr
from test_torch_resnet import CFGS, OPTS, STAGES, _cos_rows, _images, _np, make_pair, tok
from test_torch_resnet import fairface, debias_models, pairs  # noqa: F401 (fixtures)

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def load_jax_quantized(tq: tqr.QuantResNet, jq) -> None:
    """Copy JAX ``quantize_resnet_visual``'s int8 weights, scales and folded
    biases into the port's ``QuantResNet`` (and its GEMM layouts)."""

    def conv(m: tqr.QConv, w, b):
        q = _t(w["q"])
        k = q.numel() // q.shape[-1]
        m.q.copy_(q)
        m.scale.copy_(_t(w["scale"]))
        m.bias.copy_(_t(b))
        m.q2.zero_()
        m.q2[:k, :q.shape[-1]].copy_(q.reshape(k, -1))
        m.q2t.copy_(m.q2.t())

    def mat(m: tquant.QWeight, w):
        m.q.copy_(_t(w["q"]))
        m.scale.copy_(_t(w["scale"]))
        m.qt.copy_(m.q.t())

    def one(m: tqr.Q1x1, w, b):
        mat(m.w, w)
        m.bias.copy_(_t(b))

    with torch.no_grad():
        for i in (1, 2, 3):
            conv(getattr(tq, f"conv{i}"), jq[f"conv{i}"], jq[f"bias{i}"])
        for stage, jstage in zip(tq.stages(), (jq[f"layer{i}"] for i in range(1, 5))):
            for blk, jb in zip(stage, jstage):
                one(blk.conv1, jb["conv1"], jb["bias1"])
                conv(blk.conv2, jb["conv2"], jb["bias2"])
                one(blk.conv3, jb["conv3"], jb["bias3"])
                if blk.downsample is not None:
                    one(blk.downsample, jb["downsample"]["conv"], jb["downsample"]["bias"])
        for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
            mat(getattr(tq.attnpool, name), jq["attnpool"][name]["w"])


def _jax_codes(x, stride, padding, wq):
    """The codes, scales and int32 accumulators of JAX ``int8_conv``,
    step by step as it computes them."""
    x32 = jnp.asarray(x, jnp.float32)
    s_x = jnp.maximum(jnp.max(jnp.abs(x32), axis=(1, 2, 3), keepdims=True) / 127.0, 1e-8)
    xq = jnp.clip(jnp.round(x32 / s_x), -127, 127).astype(jnp.int8)
    acc = jax.lax.conv_general_dilated(
        xq, wq["q"], (stride, stride), ((padding, padding), (padding, padding)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    return np.asarray(xq), np.asarray(s_x), np.asarray(acc)


class TestWeights:
    @pytest.mark.parametrize("shape", [(3, 3, 3, 8), (3, 3, 8, 16), (1, 1, 16, 24)])
    def test_quantize_conv_weight_bit_exact(self, shape):
        rng = np.random.default_rng(1)
        w = rng.normal(size=shape).astype(np.float32)
        w[..., 1] = 0.0  # an all-zero channel: the scale's 1e-8 clamp
        w[..., 0] = rng.choice([-3.5, -0.5, 0.5, 2.5], size=shape[:3])  # .5 ties ...
        w.reshape(-1, shape[-1])[0, 0] = 127.0  # ... at a scale of exactly 1
        want = jqr.quantize_conv_weight(jnp.asarray(w))
        got = tqr.quantize_conv_weight(torch.from_numpy(w))
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
        np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
        assert got["q"].dtype == torch.int8 and got["scale"].shape == (shape[-1],)

    @pytest.mark.parametrize("stages", STAGES)
    def test_fold_bn_within_1e6(self, pairs, stages):
        jp, _, model = pairs[stages]
        for ours, theirs in ((model.visual, jp["visual"]),
                             (model.visual.layer2[0], jp["visual"]["layer2"][0])):
            for i in (1, 2, 3):
                w, b = tqr.fold_bn(getattr(ours, f"conv{i}"), getattr(ours, f"bn{i}"))
                jw, jb = jqr.fold_bn(theirs[f"conv{i}"], theirs[f"bn{i}"])
                np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=0)
                np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-7)

    def test_gemm_layout_pads_k_and_n_with_zeros(self):
        w = torch.randn(3, 3, 3, 40, generator=torch.Generator().manual_seed(2))
        m = tqr.QConv(w, torch.zeros(40))  # RN50x4's first stem conv: K = 27, N = 40
        assert m.q2.shape == (32, 48) and m.q2t.shape == (48, 32)
        assert torch.equal(m.q2[:27, :40], m.q.reshape(27, 40))
        assert not m.q2[27:].any() and not m.q2[:, 40:].any()
        assert torch.equal(m.q2t, m.q2.t())


class TestInt8Conv:
    @pytest.mark.parametrize("c_in,hw,stride,padding", [
        (3, 16, 2, 1),  # the stem's first conv: K = 27
        (8, 9, 1, 1),
        (8, 9, 2, 1),
        (8, 10, 1, 0),
    ])
    def test_codes_and_accumulators_exact(self, c_in, hw, stride, padding):
        rng = np.random.default_rng(c_in * 100 + hw + stride)
        x = rng.normal(size=(3, hw, hw, c_in)).astype(np.float32)
        x[1] *= 1e-3  # another per-image scale
        w = rng.normal(size=(3, 3, c_in, 16)).astype(np.float32)
        b = rng.normal(size=16).astype(np.float32)
        jq = jqr.quantize_conv_weight(jnp.asarray(w))
        xq_j, s_j, acc_j = _jax_codes(x, stride, padding, jq)
        m = tqr.QConv(torch.from_numpy(w), torch.from_numpy(b))
        xq, s_x = tqr.quant_images(torch.from_numpy(x))
        np.testing.assert_array_equal(xq.numpy(), xq_j)
        np.testing.assert_array_equal(s_x.numpy(), s_j)
        cols = tqr.im2col(xq, 3, 3, stride, padding, m.q2.shape[0] - 9 * c_in)
        acc = fbq.int_mm(cols, m.q2, m.q2t).reshape(acc_j.shape)
        np.testing.assert_array_equal(acc.numpy(), acc_j)
        want = np.asarray(jqr.int8_conv(jnp.asarray(x), jq, jnp.asarray(b), stride=stride,
                                        padding=padding))
        got = tqr.int8_conv(torch.from_numpy(x), m, stride=stride, padding=padding)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("c_out", [8, 40, 48])
    def test_padded_output_channels_are_exact(self, c_out):
        """The GEMM's N is padded to a multiple of 16 with zero columns: the
        output equals the product with the unpadded kernel."""
        rng = np.random.default_rng(c_out)
        x = torch.from_numpy(rng.normal(size=(2, 9, 9, 8)).astype(np.float32))
        m = tqr.QConv(torch.from_numpy(rng.normal(size=(3, 3, 8, c_out)).astype(np.float32)),
                      torch.from_numpy(rng.normal(size=c_out).astype(np.float32)))
        assert m.q2.shape == (72, -(-c_out // 16) * 16) and not m.q2[:, c_out:].any()
        xq, s_x = tqr.quant_images(x)
        acc = torch._int_mm(tqr.im2col(xq, 3, 3, 1, 1), m.q.reshape(72, c_out))
        want = acc.reshape(2, 9, 9, c_out).float() * s_x * m.scale + m.bias
        assert torch.equal(tqr.int8_conv(x, m, padding=1), want)

    def test_bfloat16_activations_keep_their_dtype(self):
        rng = np.random.default_rng(4)
        x = torch.from_numpy(rng.normal(size=(2, 8, 8, 8)).astype(np.float32))
        m = tqr.QConv(torch.from_numpy(rng.normal(size=(3, 3, 8, 16)).astype(np.float32)),
                      torch.zeros(16))
        out = tqr.int8_conv(x.bfloat16(), m, padding=1)
        assert out.dtype == torch.bfloat16 and out.shape == (2, 8, 8, 16)


@pytest.fixture(scope="module")
def quantized(pairs):
    """{stages: (JAX int8 tree, the port's own QuantResNet, a QuantResNet
    holding JAX's int8 weights)}."""
    out = {}
    for stages, (jp, _, model) in pairs.items():
        jq = jqr.quantize_resnet_visual(jp["visual"])
        own = tqr.quantize_resnet_visual(model.visual)
        same = tqr.quantize_resnet_visual(model.visual)
        load_jax_quantized(same, jq)
        out[stages] = jq, own, same
    return out


class TestTower:
    @pytest.mark.parametrize("stages", STAGES)
    def test_float32_matches_jax_on_the_same_weights(self, pairs, quantized, stages):
        jq, _, same = quantized[stages]
        x = _images(21)
        want = np.asarray(jqr.encode_image_resnet_q(jq, jnp.asarray(x), CFGS[stages].vision,
                                                    dtype=jnp.float32))
        with torch.no_grad():
            got = _np(tqr.encode_image_resnet_q(same, torch.from_numpy(x),
                                                dtype=torch.float32))
        assert _cos_rows(got, want).min() >= 0.99999

    @pytest.mark.parametrize("stages", STAGES)
    def test_each_quantization_tracks_the_float_tower(self, pairs, quantized, stages):
        jp, _, model = pairs[stages]
        jq, own, _ = quantized[stages]
        x = _images(22)
        with torch.no_grad():
            ref = _np(model.encode_image(torch.from_numpy(x)))
            got = _np(tqr.encode_image_resnet_q(own, torch.from_numpy(x),
                                                dtype=torch.float32))
            got16 = _np(tqr.encode_image_resnet_q(own, torch.from_numpy(x)))
        want = np.asarray(jqr.encode_image_resnet_q(jq, jnp.asarray(x), CFGS[stages].vision,
                                                    dtype=jnp.float32))
        assert _cos_rows(got, ref).min() > 0.99
        assert _cos_rows(got16, ref).min() > 0.99
        assert _cos_rows(want, ref).min() > 0.99

    def test_pool_projections_share_the_float_parameters(self, pairs, quantized):
        _, _, model = pairs[STAGES[0]]
        _, own, _ = quantized[STAGES[0]]
        ap = model.visual.attnpool
        assert own.attnpool.positional_embedding is ap.positional_embedding
        assert own.attnpool.c_proj_bias is ap.c_proj.bias
        assert own.layer2[0].stride == 2 and own.layer2[0].downsample is not None


class TestQuantizedCLIP:
    def test_encode_image_is_the_resnet_int8_tower(self, pairs):
        _, _, model = pairs[STAGES[1]]
        qm = tquant.QuantizedCLIP(model)
        assert isinstance(qm.visual_q, tqr.QuantResNet)
        x = torch.from_numpy(_images(23, b=2))
        with torch.no_grad():
            got = qm.encode_image(x, fused=True)
            want = tqr.encode_image_resnet_q(qm.visual_q, x)
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)

    def test_patch_staging_lookalike_never_takes_the_vit_stem(self, pairs, monkeypatch):
        _, _, model = pairs[STAGES[0]]
        vis = model.cfg.vision
        assert vis.patch_size == 32  # as the registry's ResNets: 64 px -> 2 x 2 patches

        def vit_stem(*a, **k):
            raise AssertionError("a ResNet took the ViT stem")

        monkeypatch.setattr(tquant, "encode_image_vit_q_p8", vit_stem)
        monkeypatch.setattr(tquant, "encode_image_vit_q", vit_stem)
        qm = tquant.QuantizedCLIP(model)
        staged = torch.zeros(2, (vis.image_size // 32) ** 2, 32 * 32 * 3, dtype=torch.uint8)
        assert tquant.is_patch_staging(staged, vis)
        with pytest.raises(ValueError, match="NHWC"):
            qm.encode_image(staged)

    def test_rn50_patch_shape_lookalike(self, monkeypatch):
        from debias_vision_lang_torch.core.registry import resolve_arch

        vis = resolve_arch("RN50").vision
        staged = torch.zeros(1, 49, 3072, dtype=torch.uint8)
        assert tquant.is_patch_staging(staged, vis)  # so the kind decides first
        with pytest.raises(ValueError, match="NHWC"):
            tqr.encode_image_resnet_q(None, staged)

    def test_resolve_compute_warns_and_names_no_tpu_figure(self, pairs):
        _, _, model = pairs[STAGES[0]]
        with pytest.warns(UserWarning, match="ModifiedResNet") as rec:
            qm, dt = tquant.resolve_compute(model, "int8")
        text = " ".join(str(w.message) for w in rec)
        for word in ("TPU", "v5e", "0.9"):
            assert word not in text
        assert isinstance(qm, tquant.QuantizedCLIP) and dt == torch.bfloat16
        assert tquant.resolve_compute(qm, "int8")[0] is qm  # idempotent, no re-wrap
        with torch.no_grad():
            assert torch.isfinite(qm.encode_image(torch.from_numpy(_images(24, b=1)))).all()

    def test_int8_text_quantizes_the_text_tower(self, debias_models):
        _, tm = debias_models
        with pytest.warns(UserWarning, match="ModifiedResNet"):
            qm, _ = tquant.resolve_compute(tm, "int8-text")
        assert qm.text_q is not None
        ids = torch.from_numpy(tok(["a photo", "a face", "a person"]))
        with torch.no_grad():
            got = qm.encode_text(ids).float()
            ref = tm.encode_text(ids)
        assert _cos_rows(_np(got), _np(ref)).min() > 0.99

    def test_auto_takes_bfloat16_as_jax(self, pairs):
        """"auto" on a ModifiedResNet is the bfloat16 rung (JAX's
        resolve_rung): no wrap, no int8 warning."""
        _, _, model = pairs[STAGES[0]]
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got, dt = tquant.resolve_compute(model, "auto")
        assert got is model and dt == torch.bfloat16
        assert tquant.resolve_rung(model, "auto") == "bfloat16"

    def test_fingerprint_names_the_float_tower(self, pairs):
        from debias_vision_lang_torch.utils.fingerprint import image_tower_tensors

        _, _, model = pairs[STAGES[0]]
        qm = tquant.QuantizedCLIP(model)
        assert set(image_tower_tensors(qm)) == set(model.visual.state_dict(prefix="visual."))


def test_measure_bias_int8_against_jax(fairface, debias_models, tmp_path):  # noqa: F811
    """The int8 rung through both pipelines on the same int8 weights.  Its
    activations are bfloat16, where the JAX tower is not one function: its
    jitted pipeline and its eager tower do not agree bit for bit on these
    images (XLA fuses and reorders the jitted arithmetic), and a flipped
    int8 code moves ranks inside the top 4 of 8.  So the rows are
    held to JAX's at the rung's bar (cosine >= 0.999), and the metrics to
    each package's numpy oracle on its own rows."""
    from debias_vision_lang_tpu.eval.measure import measure_bias
    from debias_vision_lang_tpu.ops.quant import QuantizedCLIP as JQuantizedCLIP
    from debias_vision_lang_tpu.vision.preprocess import Preprocess
    from debias_vision_lang_torch.eval.measure import measure_bias as tmeasure_bias
    from debias_vision_lang_torch.vision.preprocess import Preprocess as TPreprocess

    jm, tm = debias_models
    qm = tquant.QuantizedCLIP(tm)
    load_jax_quantized(qm.visual_q, JQuantizedCLIP(jm).visual_q)
    opts = {**OPTS, "data_path": fairface, "dtype": "int8"}
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    with pytest.warns(UserWarning):  # JAX's own ResNet int8 warning
        want = measure_bias(jm, Preprocess(64), tok, "gender",
                            opts={**opts, "cache_embeddings": jpath})
    got = tmeasure_bias(qm, TPreprocess(64), tok, "gender",
                        opts={**opts, "cache_embeddings": tpath})
    oracle = tmeasure_bias(qm, TPreprocess(64), tok, "gender",
                           opts={**opts, "cache_embeddings": tpath, "engine": "oracle"})
    assert set(got) == set(want) == {"maxskew", "ndkl"}
    with np.load(jpath) as j, np.load(tpath) as t:
        np.testing.assert_array_equal(t["labels"], j["labels"])
        assert _cos_rows(t["embeddings"], j["embeddings"]).min() >= 0.999
    for ev in got:
        for k in got[ev]:
            assert got[ev][k] == pytest.approx(oracle[ev][k], abs=1e-5)


def test_make_pair_redraws_every_batch_norm():
    _, tree, model = make_pair(CFGS[STAGES[0]], seed=3)
    bn3 = model.visual.layer1[0].bn3
    assert float(bn3.scale.detach().min()) >= 0.2 and float(bn3.var.detach().min()) >= 0.5
    assert float(model.visual.bn3.scale.detach().min()) >= 0.5  # the stem's bn3 is no branch end
    with torch.no_grad():
        out = model.encode_image(torch.from_numpy(_images(25, b=1)))
    assert np.isfinite(_np(out)).all()
    ref = np.asarray(jres.encode_image_resnet(jax.tree.map(jnp.asarray, tree)["visual"],
                                              jnp.asarray(_images(25, b=1)),
                                              CFGS[STAGES[0]].vision))
    np.testing.assert_allclose(_np(out), ref, atol=1e-5 * max(1.0, np.abs(ref).max()))
