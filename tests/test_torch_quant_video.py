"""The int8 Frozen-in-Time towers of the PyTorch port (ops/quant.py:
``quantize_video_visual``, ``encode_video_q``, ``encode_video_divided_q``
and ``QuantizedCLIP`` over a video bundle) against the JAX package's, on the
CPU at the tiny size of tests/test_torch_frozen_in_time.py (the same
weights, temporal out-projections redrawn away from zero).

Bars: the int8 weights bit-exact, per layer of the stacked temporal
attention too; the plain float32 int8 towers within 5e-3 of JAX's XLA int8
path (the ViT int8 bar of tests/test_torch_quant.py) and at cosine > 0.99
against the float tower (the JAX package's bar, tests/test_quant_video.py);
the bfloat16 towers (the fused twins on the CPU) at cosine >= 0.999 against
JAX's bf16 int8 towers; ``QuantizedCLIP`` dispatching on the bundle's
formulation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debias_vision_lang_tpu.ops import quant as jquant
from debias_vision_lang_torch.models.debias import DebiasCLIP as TDebiasCLIP
from debias_vision_lang_torch.ops import fused_block_q as fbq
from debias_vision_lang_torch.ops import quant as tquant
from test_torch_frozen_in_time import (CFG, TCFG, _cos_rows, _np, fit_params_np,
                                       port_model)
from debias_vision_lang_tpu.core.config import DebiasConfig
from torch_port_config import port_config

torch.set_num_threads(1)

XLA_INT8_ATOL = 5e-3
JAX_Q = {"joint": jquant.encode_video_q, "divided": jquant.encode_video_divided_q}
PORT_Q = {"joint": tquant.encode_video_q, "divided": tquant.encode_video_divided_q}


@pytest.fixture(scope="module")
def quad():
    """(JAX int8 tree, port QuantVideoVisual, JAX float params, port model)."""
    np_params = fit_params_np()
    jp = jax.tree.map(jnp.asarray, np_params)
    model = port_model(np_params)
    return jquant.quantize_video_visual(jp["visual"]), tquant.quantize_video_visual(
        model.visual), jp, model


@pytest.fixture(scope="module")
def videos():
    return np.random.default_rng(13).normal(size=(3, 4, 32, 32, 3)).astype(np.float32)


def _port(fn, vq, x, **kw):
    with torch.no_grad():
        return fn(vq, torch.from_numpy(np.asarray(x)), **kw)


class TestWeights:
    def test_quantize_video_visual_bit_exact(self, quad):
        jq, tq, _, _ = quad
        for name in ("conv1",):
            np.testing.assert_array_equal(_np(getattr(tq, name).q), np.asarray(jq[name]["q"]))
            np.testing.assert_array_equal(_np(getattr(tq, name).scale),
                                          np.asarray(jq[name]["scale"]))
        jt = jq["temporal_attn"]["attn"]
        for i, blk in enumerate(tq.temporal):
            for w in ("wqkv", "wo"):
                np.testing.assert_array_equal(_np(getattr(blk, w).q), np.asarray(jt[w]["q"][i]))
                np.testing.assert_array_equal(_np(getattr(blk, w).scale),
                                              np.asarray(jt[w]["scale"][i]))
                assert torch.equal(getattr(blk, w).qt, getattr(blk, w).q.t())
            np.testing.assert_array_equal(_np(blk.bqkv), np.asarray(jt["bqkv"][i]))
            np.testing.assert_array_equal(_np(blk.ln_1.scale),
                                          np.asarray(jq["temporal_attn"]["ln_t"]["scale"][i]))
        jr = jq["resblocks"]
        for i, blk in enumerate(tq.resblocks):
            for w, grp in (("wqkv", "attn"), ("wo", "attn"), ("w1", "mlp"), ("w2", "mlp")):
                np.testing.assert_array_equal(_np(getattr(blk, w).q),
                                              np.asarray(jr[grp][w]["q"][i]))


class TestTowers:
    @pytest.mark.parametrize("mode", ["joint", "divided"])
    def test_float32_matches_jax_xla_int8(self, quad, videos, mode):
        jq, tq, _, _ = quad
        want = JAX_Q[mode](jq, jnp.asarray(videos), CFG.vision, dtype=jnp.float32)
        got = _port(PORT_Q[mode], tq, videos, dtype=torch.float32)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=XLA_INT8_ATOL)

    @pytest.mark.parametrize("mode", ["joint", "divided"])
    def test_float32_close_to_the_float_tower(self, quad, videos, mode):
        _, tq, _, model = quad
        got = _port(PORT_Q[mode], tq, videos, dtype=torch.float32)
        with torch.no_grad():
            ref = model.visual(torch.from_numpy(videos), attention=mode)
        assert _cos_rows(_np(got), _np(ref)).min() > 0.99

    @pytest.mark.parametrize("mode", ["joint", "divided"])
    def test_bfloat16_runs_the_fused_twins(self, quad, videos, mode, monkeypatch):
        """bf16: every spatial / joint block through the int8 fused entry
        points (their twins here), cosine >= 0.999 against JAX's bf16 int8
        tower; the divided tower's temporal attention stays on the plain
        int8 path."""
        jq, tq, _, _ = quad
        calls = []
        orig = fbq.attention_block_q
        monkeypatch.setattr(fbq, "attention_block_q",
                            lambda x, *a, **k: calls.append(x.shape[1]) or orig(x, *a, **k))
        got = _port(PORT_Q[mode], tq, videos, dtype=torch.bfloat16)
        want = JAX_Q[mode](jq, jnp.asarray(videos), CFG.vision, dtype=jnp.bfloat16)
        assert got.dtype == torch.bfloat16
        s = 1 + 4 * 16 if mode == "joint" else 16
        assert calls == [s] * CFG.vision.layers
        assert _cos_rows(_np(got), np.asarray(want, np.float32)).min() >= 0.999

    @pytest.mark.parametrize("mode", ["joint", "divided"])
    def test_fused_false_is_the_plain_int8_path(self, quad, videos, mode):
        _, tq, _, _ = quad
        plain = _port(PORT_Q[mode], tq, videos, dtype=torch.bfloat16, fused=False)
        fused = _port(PORT_Q[mode], tq, videos, dtype=torch.bfloat16)
        assert _cos_rows(_np(plain), _np(fused)).min() >= 0.999

    def test_single_frame_promotion(self, quad, videos):
        _, tq, _, _ = quad
        for mode in ("joint", "divided"):
            torch.testing.assert_close(
                _port(PORT_Q[mode], tq, videos[:, 0], dtype=torch.float32),
                _port(PORT_Q[mode], tq, videos[:, :1], dtype=torch.float32), rtol=0, atol=0)


class TestBundle:
    @pytest.mark.parametrize("attention", ["joint", "divided"])
    def test_quantized_clip_takes_the_bundle_formulation(self, attention, videos):
        np_params = fit_params_np()
        model = port_model(np_params, attention=attention)
        q = tquant.QuantizedCLIP(model)
        assert isinstance(q.visual_q, tquant.QuantVideoVisual)
        got = _port(lambda _, x, **kw: q.encode_image(x, **kw), None, videos,
                    dtype=torch.float32)
        want = _port(PORT_Q[attention], q.visual_q, videos, dtype=torch.float32)
        assert torch.equal(got, want)
        assert torch.equal(_port(lambda _, x, **kw: q.encode_video(x, **kw), None, videos,
                                 dtype=torch.float32), got)

    def test_debias_over_fit_and_the_ladder(self, videos):
        model = port_model(fit_params_np(), attention="divided")
        deb = TDebiasCLIP(model, torch.zeros(2, 32),
                          port_config(DebiasConfig(num_debias_tokens=2, hidden_dim=32)))
        qm, dt = tquant.resolve_compute(deb, "int8")
        assert isinstance(qm, tquant.QuantizedCLIP) and dt == torch.bfloat16
        got = _port(lambda _, x, **kw: qm.encode_image(x, **kw), None, videos,
                    dtype=torch.float32)
        want = _port(tquant.encode_video_divided_q, qm.visual_q, videos, dtype=torch.float32)
        assert torch.equal(got, want)
        qt, _ = tquant.resolve_compute(deb, "int8-text")
        assert qt.text_q is not None

    def test_jax_quantized_clip_agrees(self, videos):
        """The two QuantizedCLIPs over the same FiT bundle, float32."""
        from debias_vision_lang_tpu.models.frozen_in_time import FrozenInTime

        np_params = fit_params_np()
        jm = FrozenInTime(params=jax.tree.map(jnp.asarray, np_params), cfg=CFG,
                          attention="divided")
        want = jquant.QuantizedCLIP(jm).encode_image(jnp.asarray(videos), dtype=jnp.float32)
        got = tquant.QuantizedCLIP(port_model(np_params, attention="divided"))
        with torch.no_grad():
            out = got.encode_image(torch.from_numpy(videos), dtype=torch.float32)
        np.testing.assert_allclose(_np(out), np.asarray(want), atol=XLA_INT8_ATOL)
        assert TCFG.vision.kind == "video_vit"
