"""Fused-block entry points of the PyTorch port (debias_vision_lang_torch/
ops/fused_block.py) against the JAX package's Pallas kernels.

CPU: the port's plain twins against the Pallas kernels run with
``interpret=True`` (as tests/test_fused_block.py runs them) -- float32 at
the JAX package's own fused-vs-XLA bar (atol 2e-5), bfloat16 within one
bf16 ulp of the output's magnitude -- and whole blocks against
``_kernel_math_resblock``; the differentiable blocks
(``fused_resblock_diff``) against ``jax.vjp`` of ``_kernel_math_resblock``
for x and all 12 block tensors, float32 at 2e-5 of the largest magnitude and
bfloat16 at a per-tensor cosine of at least 0.9999.  The int8 twins (ops/fused_block_q.py) against
the int8 Pallas kernels, single-chain (bb=1) and chain (bb=3) variants:
float32 at atol 1e-4, bfloat16 within one bf16 ulp.  CUDA (marker
``cuda``, skipped without a card): the hand-written kernels against the
twins at the main path's shapes, the wgmma attention core at every key
bucket (in the bf16 and the int8 attention blocks), its long route past
320 keys (S = 321 to 785, the route counted), a ragged M, and widths off
the GEMMs' tiles with head dims other than 64 (the padded operand layout;
tests/test_torch_shapes.py holds it on the CPU).  On the CPU, ``core_route`` and the twins at
S = 400, where the card takes the long route, against the JAX kernels.  A source check holds the int8 attention
block to the s8 wgmma GEMM and the wgmma core.

jax is imported inside the JAX-side helpers only, so the CUDA tests run on
a machine without jax:  python -m pytest tests/test_torch_fused_block.py
-m cuda --noconftest -p no:randomly
"""

import math
import pathlib

import numpy as np
import pytest
import torch

from debias_vision_lang_torch.models.layers import ResidualBlock
from debias_vision_lang_torch.ops import fused_block as fb
from debias_vision_lang_torch.ops import fused_block_q as fbq
from debias_vision_lang_torch.ops import quant

torch.set_num_threads(1)

B, S, D, H = 3, 13, 32, 2  # odd batch, ragged sequence


def _layer_np(rng, d):
    def rn(*shape, std=1.0):
        return (rng.normal(size=shape) * std).astype(np.float32)

    return {
        "ln_1": {"scale": 1 + rn(d, std=0.1), "bias": rn(d, std=0.1)},
        "attn": {"wqkv": rn(d, 3 * d, std=d ** -0.5), "bqkv": rn(3 * d, std=0.1),
                 "wo": rn(d, d, std=d ** -0.5), "bo": rn(d, std=0.1)},
        "ln_2": {"scale": 1 + rn(d, std=0.1), "bias": rn(d, std=0.1)},
        "mlp": {"w1": rn(d, 4 * d, std=(2 * d) ** -0.5), "b1": rn(4 * d, std=0.1),
                "w2": rn(4 * d, d, std=(4 * d) ** -0.5), "b2": rn(d, std=0.1)},
    }


def _port_block(layer):
    blk = ResidualBlock(layer["ln_1"]["scale"].shape[0])
    blk.load_state_dict({f"{g}.{k}": torch.from_numpy(v)
                         for g, sub in layer.items() for k, v in sub.items()})
    return blk


def _attn_args(layer):
    a = layer["attn"]
    return (layer["ln_1"]["scale"], layer["ln_1"]["bias"], a["wqkv"], a["bqkv"],
            a["wo"], a["bo"])


def _mlp_args(layer):
    m = layer["mlp"]
    return (layer["ln_2"]["scale"], layer["ln_2"]["bias"], m["w1"], m["b1"],
            m["w2"], m["b2"])


@pytest.fixture(scope="module")
def layer():
    return _layer_np(np.random.default_rng(0), D)


@pytest.fixture(scope="module")
def x_np():
    return np.random.default_rng(1).normal(size=(B, S, D)).astype(np.float32)


def _jnp(a, dtype=None):
    import jax.numpy as jnp

    out = jnp.asarray(a)
    return out if dtype is None else out.astype(dtype)


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np32(t):
    return np.asarray(t.detach().float() if torch.is_tensor(t) else t, np.float32)


def _within_one_ulp(got, ref):
    """|got - ref| <= one bf16 ulp at the output's largest magnitude."""
    got, ref = _np32(got), _np32(ref)
    ulp = 2.0 ** (math.floor(math.log2(np.abs(ref).max())) - 7)
    err = np.abs(got - ref).max()
    assert err <= ulp, f"max err {err} > 1 bf16 ulp {ulp}"


class TestTwinsAgainstPallas:
    @pytest.mark.parametrize("causal", [False, True])
    def test_attention_f32(self, layer, x_np, causal):
        from debias_vision_lang_tpu.ops.fused_block import attention_block

        ref = attention_block(_jnp(x_np), *map(_jnp, _attn_args(layer)), heads=H,
                              causal=causal, interpret=True)
        got = fb.attention_block(_torch(x_np), *map(_torch, _attn_args(layer)),
                                 heads=H, causal=causal)
        np.testing.assert_allclose(_np32(got), _np32(ref), atol=2e-5)

    @pytest.mark.parametrize("act_kind", ["quick_gelu", "gelu"])
    def test_mlp_f32(self, layer, x_np, act_kind):
        from debias_vision_lang_tpu.ops.fused_block import mlp_block

        ref = mlp_block(_jnp(x_np), *map(_jnp, _mlp_args(layer)), act_kind=act_kind,
                        bb=1, interpret=True)
        got = fb.mlp_block(_torch(x_np), *map(_torch, _mlp_args(layer)),
                           act_kind=act_kind)
        np.testing.assert_allclose(_np32(got), _np32(ref), atol=2e-5)

    @pytest.mark.parametrize("causal", [False, True])
    def test_attention_bf16(self, layer, x_np, causal):
        import jax.numpy as jnp

        from debias_vision_lang_tpu.ops.fused_block import attention_block

        ref = attention_block(_jnp(x_np, jnp.bfloat16), *map(_jnp, _attn_args(layer)),
                              heads=H, causal=causal, interpret=True)
        got = fb.attention_block(_torch(x_np, torch.bfloat16),
                                 *map(_torch, _attn_args(layer)), heads=H, causal=causal)
        assert got.dtype == torch.bfloat16
        _within_one_ulp(got, ref)

    @pytest.mark.parametrize("act_kind", ["quick_gelu", "gelu"])
    def test_mlp_bf16(self, layer, x_np, act_kind):
        import jax.numpy as jnp

        from debias_vision_lang_tpu.ops.fused_block import mlp_block

        ref = mlp_block(_jnp(x_np, jnp.bfloat16), *map(_jnp, _mlp_args(layer)),
                        act_kind=act_kind, bb=1, interpret=True)
        got = fb.mlp_block(_torch(x_np, torch.bfloat16), *map(_torch, _mlp_args(layer)),
                           act_kind=act_kind)
        _within_one_ulp(got, ref)


class TestWholeBlock:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_block_matches_kernel_math(self, layer, x_np, causal, dtype):
        import jax.numpy as jnp

        from debias_vision_lang_tpu.ops.fused_block import _kernel_math_resblock

        ref = _kernel_math_resblock(
            {g: {k: _jnp(v) for k, v in sub.items()} for g, sub in layer.items()},
            _jnp(x_np, getattr(jnp, dtype)), H, "quick_gelu", causal=causal)
        got = fb.fused_resblock(_port_block(layer), _torch(x_np, getattr(torch, dtype)),
                                H, causal=causal)
        if dtype == "float32":
            np.testing.assert_allclose(_np32(got), _np32(ref), atol=2e-5)
        else:
            _within_one_ulp(got, ref)

    def test_tower_loops_layers(self, x_np):
        rng = np.random.default_rng(2)
        blocks = [_port_block(_layer_np(rng, D)) for _ in range(3)]
        x = _torch(x_np)
        want = x
        for blk in blocks:
            want = fb.fused_resblock(blk, want, H)
        torch.testing.assert_close(fb.fused_transformer(blocks, x, H), want,
                                   rtol=0, atol=0)

    def test_erf_gelu_polynomial(self):
        from debias_vision_lang_tpu.ops.fused_block import _erf_gelu

        h = np.linspace(-6, 6, 97).astype(np.float32)
        np.testing.assert_allclose(_np32(fb.erf_gelu(_torch(h))),
                                   np.asarray(_erf_gelu(_jnp(h))), atol=1e-6)


_PARAM_ORDER = [("ln_1", "scale"), ("ln_1", "bias"), ("attn", "wqkv"), ("attn", "bqkv"),
                ("attn", "wo"), ("attn", "bo"), ("ln_2", "scale"), ("ln_2", "bias"),
                ("mlp", "w1"), ("mlp", "b1"), ("mlp", "w2"), ("mlp", "b2")]


def _cosine(a, b):
    a, b = _np32(a).ravel().astype(np.float64), _np32(b).ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


class TestDifferentiableBlock:
    """The fused blocks' backward: gradients of the function the forward
    evaluated, as JAX's custom VJP gives them."""

    @pytest.mark.parametrize("causal", [False, True], ids=["image", "text"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_grads_match_jax_vjp(self, layer, x_np, causal, dtype):
        import jax
        import jax.numpy as jnp

        from debias_vision_lang_tpu.ops.fused_block import _kernel_math_resblock

        g_np = np.random.default_rng(9).normal(size=x_np.shape).astype(np.float32)
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        jp = {grp: {k: _jnp(v) for k, v in sub.items()} for grp, sub in layer.items()}
        _, vjp = jax.vjp(lambda p, y: _kernel_math_resblock(p, y, H, "quick_gelu", causal),
                         jp, _jnp(x_np, jdt))
        want_p, want_x = vjp(_jnp(g_np, jdt))

        blk = _port_block(layer)
        x = _torch(x_np, tdt).requires_grad_(True)
        out = fb.fused_resblock_diff(blk, x, H, causal=causal)
        assert out.dtype == tdt
        params = [getattr(getattr(blk, grp), k) for grp, k in _PARAM_ORDER]
        got_x, *got_p = torch.autograd.grad(out, [x] + params, _torch(g_np, tdt))
        pairs = [("x", got_x, want_x)] + [
            (f"{grp}.{k}", gp, want_p[grp][k]) for (grp, k), gp in zip(_PARAM_ORDER, got_p)]
        for name, got, want in pairs:
            assert got.shape == tuple(np.shape(want)), name
            if dtype == "float32":
                want = _np32(want)
                err = np.abs(_np32(got) - want).max()
                assert err <= 2e-5 * np.abs(want).max(), (name, err)
            else:
                assert _cosine(got, want) >= 0.9999, (name, _cosine(got, want))

    def test_forward_is_the_fused_block(self, layer, x_np):
        blk = _port_block(layer)
        x = _torch(x_np).requires_grad_(True)
        torch.testing.assert_close(fb.fused_resblock_diff(blk, x, H, causal=True),
                                   fb.fused_resblock(blk, x.detach(), H, causal=True),
                                   rtol=0, atol=0)

    def test_frozen_params_get_no_grad(self, layer, x_np):
        blk = _port_block(layer)
        blk.requires_grad_(False)
        x = _torch(x_np).requires_grad_(True)
        fb.fused_transformer_diff([blk, blk], x, H).sum().backward()
        assert x.grad is not None and bool(torch.isfinite(x.grad).all())
        assert all(p.grad is None for p in blk.parameters())

    def test_clip_towers_route_through_it(self):
        """A bf16 tower with grad mode on and a gradient to carry runs the
        differentiable blocks; under no_grad the plain fused tower."""
        from debias_vision_lang_torch.models import clip as clip_model

        blocks = torch.nn.ModuleList([_port_block(_layer_np(np.random.default_rng(4), D))])
        x = _torch(np.random.default_rng(5).normal(size=(2, 5, D)), torch.bfloat16)
        y = clip_model._fused_tower(blocks, x, H)
        assert y.grad_fn is not None and "FusedResblock" in type(y.grad_fn).__name__
        with torch.no_grad():
            assert clip_model._fused_tower(blocks, x, H).grad_fn is None


class TestRouting:
    def test_cpu_twins_do_not_count(self, layer, x_np):
        fb.reset_launches()
        fb.fused_resblock(_port_block(layer), _torch(x_np), H)
        assert fb.LAUNCHES == {"attention_block": 0, "attention_block_causal": 0,
                               "mlp_block": 0}

    def test_other_devices_raise(self, layer, x_np):
        x = _torch(x_np).to("meta")
        with pytest.raises(ValueError, match="cpu .plain twin. or cuda"):
            fb.attention_block(x, *map(_torch, _attn_args(layer)), heads=H)

    def test_unknown_act_rejected(self, layer, x_np):
        with pytest.raises(ValueError, match="act_kind"):
            fb.mlp_block(_torch(x_np), *map(_torch, _mlp_args(layer)), act_kind="relu")


class TestGemmOperands:
    """What the CUDA route hands the wgmma GEMM, checked before any launch
    (so on the CPU too): the K-major weight copies and the shapes it takes."""

    def test_kmajor_copy_is_the_transpose_in_bf16(self):
        w = torch.randn(64, 256)
        got = fb._kmajor(w, (64, 256), "w", w.device)
        assert got.dtype == torch.bfloat16 and got.shape == (256, 64) and got.is_contiguous()
        torch.testing.assert_close(got, w.t().to(torch.bfloat16), rtol=0, atol=0)

    def test_kmajor_copy_is_kept_per_version(self):
        w = torch.randn(64, 256)
        first = fb._kmajor(w, (64, 256), "w", w.device)
        assert fb._kmajor(w, (64, 256), "w", w.device) is first
        with torch.no_grad():
            w.mul_(2)  # an in-place update (an optimizer step) moves _version
        again = fb._kmajor(w, (64, 256), "w", w.device)
        assert again is not first
        torch.testing.assert_close(again, w.t().to(torch.bfloat16), rtol=0, atol=0)
        w.data = torch.randn(64, 256)  # new storage under the same parameter
        torch.testing.assert_close(fb._kmajor(w, (64, 256), "w", w.device),
                                   w.t().to(torch.bfloat16), rtol=0, atol=0)

    def test_kmajor_checks_the_shape(self):
        with pytest.raises(ValueError, match="expected shape"):
            fb._kmajor(torch.randn(64, 256), (256, 64), "w", torch.device("cpu"))

    @pytest.mark.parametrize("s", [0])
    def test_attention_rejects_sequence_lengths(self, s):
        d = 256
        x = torch.zeros(1, s, d, dtype=torch.bfloat16)
        args = (torch.ones(d), torch.zeros(d), torch.zeros(d, 3 * d), torch.zeros(3 * d),
                torch.zeros(d, d), torch.zeros(d))
        with pytest.raises(ValueError, match="sequence length"):
            fb._attention_block_cuda(x, *args, 4, False)


# ---------------------------------------------------------------------------
# Int8 blocks: the twins against the int8 Pallas kernels
# ---------------------------------------------------------------------------


def _quantized(w):
    """The port's quantize_weight of a numpy weight as numpy (q, scale): the
    same bits as the JAX function's (tests/test_torch_quant.py)."""
    qw = quant.quantize_weight(torch.from_numpy(w))
    return qw["q"].numpy(), qw["scale"].numpy()


def _attn_q_args(layer):
    a = layer["attn"]
    return (layer["ln_1"]["scale"], layer["ln_1"]["bias"], *_quantized(a["wqkv"]),
            a["bqkv"], *_quantized(a["wo"]), a["bo"])


def _mlp_q_args(layer):
    m = layer["mlp"]
    return (layer["ln_2"]["scale"], layer["ln_2"]["bias"], *_quantized(m["w1"]), m["b1"],
            *_quantized(m["w2"]), m["b2"])


def _torch_keep(a):
    """numpy -> torch, int8 codes kept, everything else float32."""
    a = np.asarray(a)
    return torch.from_numpy(a) if a.dtype == np.int8 else _torch(a)


class TestQTwinsAgainstPallas:
    @pytest.mark.parametrize("bb", [1, 3])
    @pytest.mark.parametrize("causal", [False, True])
    def test_attention_q_f32(self, layer, x_np, causal, bb):
        from debias_vision_lang_tpu.ops.fused_block_q import attention_block_q

        args = _attn_q_args(layer)
        ref = attention_block_q(_jnp(x_np), *map(_jnp, args), heads=H, causal=causal,
                                bb=bb, interpret=True)
        got = fbq.attention_block_q(_torch(x_np), *map(_torch_keep, args), heads=H,
                                    causal=causal)
        np.testing.assert_allclose(_np32(got), _np32(ref), atol=1e-4)

    @pytest.mark.parametrize("causal", [False, True])
    def test_attention_q_bf16(self, layer, x_np, causal):
        import jax.numpy as jnp

        from debias_vision_lang_tpu.ops.fused_block_q import attention_block_q

        args = _attn_q_args(layer)
        ref = attention_block_q(_jnp(x_np, jnp.bfloat16), *map(_jnp, args), heads=H,
                                causal=causal, bb=1, interpret=True)
        got = fbq.attention_block_q(_torch(x_np, torch.bfloat16), *map(_torch_keep, args),
                                    heads=H, causal=causal)
        assert got.dtype == torch.bfloat16
        _within_one_ulp(got, ref)

    @pytest.mark.parametrize("bb", [1, 3])
    @pytest.mark.parametrize("act_kind", ["quick_gelu", "gelu"])
    def test_mlp_q_f32(self, layer, x_np, act_kind, bb):
        from debias_vision_lang_tpu.ops.fused_block_q import mlp_block_q

        args = _mlp_q_args(layer)
        ref = mlp_block_q(_jnp(x_np), *map(_jnp, args), act_kind=act_kind, bb=bb,
                          interpret=True)
        got = fbq.mlp_block_q(_torch(x_np), *map(_torch_keep, args), act_kind=act_kind)
        np.testing.assert_allclose(_np32(got), _np32(ref), atol=1e-4)

    @pytest.mark.parametrize("act_kind", ["quick_gelu", "gelu"])
    def test_mlp_q_bf16(self, layer, x_np, act_kind):
        import jax.numpy as jnp

        from debias_vision_lang_tpu.ops.fused_block_q import mlp_block_q

        args = _mlp_q_args(layer)
        ref = mlp_block_q(_jnp(x_np, jnp.bfloat16), *map(_jnp, args), act_kind=act_kind,
                          bb=1, interpret=True)
        got = fbq.mlp_block_q(_torch(x_np, torch.bfloat16), *map(_torch_keep, args),
                              act_kind=act_kind)
        _within_one_ulp(got, ref)

    def test_quant_rows_matches_jax(self):
        from debias_vision_lang_tpu.ops.fused_block_q import _quant_rows

        x = np.random.default_rng(6).normal(size=(5, 7, 96)).astype(np.float32)
        x[0, 0] = 0.0  # an all-zero row: the 1e-8 scale clamp
        x[1, 1, :4] = [127.0, 2.5, -3.5, 0.5]  # amax 127 -> scale 1: ties
        want_q, want_s = _quant_rows(_jnp(x))
        got_q, got_s = fbq.quant_rows(_torch(x))
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
        assert got_q[1, 1, :4].tolist() == [127, 2, -4, 0]


class TestCoreRoute:
    """The route of K1's and K3's attention core: the register core up to
    320 keys, the two-pass long route past them (csrc/attention_wgmma.cuh
    launch_attention_wgmma), counted per launch in ``CORE_ROUTES``."""

    def test_short_up_to_320_long_past(self):
        assert {fb.core_route(s) for s in range(1, 321)} == {"short"}
        assert {fb.core_route(s) for s in range(321, 2049)} == {"long"}
        with pytest.raises(ValueError, match="< 1"):
            fb.core_route(0)
        # head dims padded to 128 stay on the register core; wider ones go long
        assert {fb.core_route(s, hd) for s in (1, 257, 320) for hd in (72, 80, 104, 128)} == {
            "short"}
        assert {fb.core_route(s, hd) for s in (1, 257) for hd in (129, 192, 256)} == {"long"}

    @pytest.mark.parametrize("mod", [fb, fbq])
    def test_cpu_twins_count_no_route(self, mod, layer):
        mod.reset_launches()
        x = _torch(np.random.default_rng(2).normal(size=(1, 400, D)))
        if mod is fb:
            fb.attention_block(x, *map(_torch, _attn_args(layer)), heads=H)
        else:
            fbq.attention_block_q(x, *map(_torch_keep, _attn_q_args(layer)), heads=H)
        assert mod.CORE_ROUTES == {"short": 0, "long": 0}
        assert sum(mod.LAUNCHES.values()) == 0

    def test_source_takes_the_long_route_past_320(self):
        csrc = pathlib.Path(fb.__file__).resolve().parent.parent / "csrc"
        core = (csrc / "attention_wgmma.cuh").read_text()
        body = core[core.index("cudaError_t launch_attention_wgmma("):]
        body = body[:body.index("\n}\n")]
        # past 320 keys, or past the register core's two 64-dim chunks, or
        # the softmax-off mode past one chunk (its register instantiations
        # are hdp 64's)
        assert ("if (S > CORE_MAX_SEQ || c > CORE_MAX_C || (norm_after == NORM_OFF && c > 1))"
                "\n    return launch_long_packed(") in body
        assert "constexpr int CORE_MAX_C = 2;" in core
        long = (csrc / "attention_long.cuh").read_text()
        packed = long[long.index("cudaError_t launch_long_packed_c("):]
        assert "attention_long_kernel<bf16, C, true>" in packed and "mask" not in packed.split(
            "// tm_m is not read")[0]
        # hdp 64 and 128 resident, any wider head the wide-head mode
        for inst in ("launch_long_packed_c<1>(", "launch_long_packed_c<2>(",
                     "if (cq > 2) {  // the wide-head mode", "attention_wide_kernel<bf16, true>"):
            assert inst in packed
        assert '#include "attention_long.cuh"' in core

    def test_sass_check_long_names_every_instantiation(self, monkeypatch):
        """chip_smoke.sass_check_long finds the long route's instantiations
        by their mangled names (the resident attention_long_kernel<T, C,
        packed> and the wide-head mode's attention_wide_kernel<T, packed>)
        and fails on a missing one, on one without its wgmma / TMA forms,
        and on mma.sync."""
        import sys

        sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
        import chip_smoke as C

        bf, f = "13__nv_bfloat16", "f"
        forms = {bf: "HGMMA.64x64x16.F32.BF16 ; UTMALDG.3D ;",
                 f: "HGMMA.64x64x8.F32.TF32 ; UTMALDG.3D ;"}
        attn = {f"_ZN12_GLOBAL__N_121attention_long_kernelI{t}Li{c}ELb0EEEv": forms[t]
                for t in (bf, f) for c in (1, 2, 3)}
        attn.update({f"_ZN12_GLOBAL__N_121attention_wide_kernelI{t}Lb0EEEv": forms[t]
                     for t in (bf, f)})
        packed = {f"_ZN12_GLOBAL__N_121attention_long_kernelI{bf}Li{c}ELb1EEEv": forms[bf]
                  for c in (1, 2)}
        packed[f"_ZN12_GLOBAL__N_121attention_wide_kernelI{bf}Lb1EEEv"] = forms[bf]
        for lib, funcs in (("attention", {**attn, **packed}), ("fused_block", packed)):
            monkeypatch.setattr(C, "sass_functions", lambda path, funcs=funcs: dict(funcs))
            C.sass_check_long(lib, "lib.so")
            wide = next(k for k in funcs if "wide_kernel" in k)
            for broken in ({wide: "UTMALDG.3D ;"}, {wide: forms[bf] + " HMMA.1688.F32.TF32 ;"},
                           {wide: None}):
                bad = {k: v for k, v in {**funcs, **broken}.items() if v is not None}
                monkeypatch.setattr(C, "sass_functions", lambda path, bad=bad: bad)
                with pytest.raises(RuntimeError):
                    C.sass_check_long(lib, "lib.so")


LONG_B, LONG_S, LONG_D, LONG_H = 2, 400, 128, 2  # past the register core's 320 keys


@pytest.fixture(scope="module")
def long_layer():
    return _layer_np(np.random.default_rng(40), LONG_D)


@pytest.fixture(scope="module")
def long_x():
    return np.random.default_rng(41).normal(size=(LONG_B, LONG_S, LONG_D)).astype(np.float32)


class TestLongTwinsAgainstPallas:
    """At S = 400, where the CUDA core takes its long route, the twins it is
    held to on the card against the JAX kernels in interpret mode: K1
    float32 at 2e-5 and bfloat16 within one bf16 ulp, K3 at bfloat16 (the
    rung it runs on) within one bf16 ulp, causal and not.  K3 at float32 is
    not held here: over 400 keys the two f32 sums of an attention row round
    apart often enough that some of its int8 codes flip (0.1-0.2% of the
    outputs move by ~1e-3, one code step through ``wo``)."""

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_attention(self, long_layer, long_x, causal, dtype):
        import jax.numpy as jnp

        from debias_vision_lang_tpu.ops.fused_block import attention_block

        jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (
            jnp.bfloat16, torch.bfloat16)
        args = _attn_args(long_layer)
        ref = attention_block(_jnp(long_x, jdt), *map(_jnp, args), heads=LONG_H,
                              causal=causal, interpret=True)
        got = fb.attention_block(_torch(long_x, tdt), *map(_torch, args), heads=LONG_H,
                                 causal=causal)
        if dtype == "float32":
            np.testing.assert_allclose(_np32(got), _np32(ref), atol=2e-5)
        else:
            _within_one_ulp(got, ref)

    @pytest.mark.parametrize("causal", [False, True])
    def test_attention_q_bf16(self, long_layer, long_x, causal):
        import jax.numpy as jnp

        from debias_vision_lang_tpu.ops.fused_block_q import attention_block_q

        args = _attn_q_args(long_layer)
        ref = attention_block_q(_jnp(long_x, jnp.bfloat16), *map(_jnp, args), heads=LONG_H,
                                causal=causal, bb=1, interpret=True)
        got = fbq.attention_block_q(_torch(long_x, torch.bfloat16), *map(_torch_keep, args),
                                    heads=LONG_H, causal=causal)
        _within_one_ulp(got, ref)


class TestQAttentionSource:
    """The int8 attention block's CUDA source runs the machinery of the
    other Hopper kernels: no mma.sync left, both products on the s8 wgmma
    GEMM, the core on the shared wgmma core."""

    SRC = (pathlib.Path(fbq.__file__).resolve().parent.parent / "csrc" / "fused_block_q.cu"
           ).read_text()

    @pytest.mark.parametrize("name", ["mma.sync", "gemm_q_kernel", "attention_core_kernel",
                                      "ldsm_x4", "mma_16816", "mma_16832_s8", "ldmatrix"])
    def test_no_mma_sync_design_left(self, name):
        assert name not in self.SRC

    def test_entry_point_runs_the_s8_gemm_and_the_wgmma_core(self):
        body = self.SRC[self.SRC.index("int attention_block_q_impl("):
                        self.SRC.index("int mlp_block_q_impl(")]
        assert body.count("launch_gemm_s8<EQ_BIAS>(") == 1
        assert body.count("launch_gemm_s8<EQ_BIAS_RESID>(") == 1
        assert body.count("launch_attention_wgmma(") == 1
        assert '#include "attention_wgmma.cuh"' in self.SRC


class TestQRouting:
    def test_cpu_twins_do_not_count(self, layer, x_np):
        blk = quant.QuantBlock(_port_block(layer))
        fbq.reset_launches()
        fbq.fused_resblock_q(blk, _torch(x_np, torch.bfloat16), H, causal=True)
        assert fbq.LAUNCHES == {"attention_block_q": 0, "attention_block_q_causal": 0,
                                "mlp_block_q": 0}

    def test_other_devices_raise(self, layer, x_np):
        x = _torch(x_np).to("meta")
        with pytest.raises(ValueError, match="cpu .plain twin. or cuda"):
            fbq.attention_block_q(x, *map(_torch_keep, _attn_q_args(layer)), heads=H)

    def test_unknown_act_rejected(self, layer, x_np):
        with pytest.raises(ValueError, match="act_kind"):
            fbq.mlp_block_q(_torch(x_np), *map(_torch_keep, _mlp_q_args(layer)),
                            act_kind="relu")

    def test_twin_scratch(self, layer, x_np):
        scratch = {}
        fbq.attention_block_q(_torch(x_np), *map(_torch_keep, _attn_q_args(layer)),
                              heads=H, scratch=scratch)
        assert set(scratch) == {"xn", "xq", "xs", "attn", "aq", "as"}
        q, s = fbq.quant_rows(scratch["attn"])
        assert torch.equal(q, scratch["aq"]) and torch.equal(s, scratch["as"])
        assert scratch["aq"].shape == (B, S, D) and scratch["as"].shape == (B, S, 1)


# ---------------------------------------------------------------------------
# CUDA: the hand-written kernels against the twins on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled with nvcc "
                    "for sm_90a and have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cuda_layer(d, device):
    layer = _layer_np(np.random.default_rng(3), d)
    return {g: {k: torch.from_numpy(v).to(device) for k, v in sub.items()}
            for g, sub in layer.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,heads,causal", [
    (8, 197, 768, 12, False), (3, 197, 768, 12, True), (5, 77, 512, 8, True)])
def test_cuda_attention_kernel_matches_twin(cuda, b, s, d, heads, causal):
    layer = _cuda_layer(d, cuda)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(b, s, d))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    args = [t for t in (layer["ln_1"]["scale"], layer["ln_1"]["bias"],
                        *layer["attn"].values())]
    fb.reset_launches()
    got = fb.attention_block(x, *args, heads=heads, causal=causal)
    torch.cuda.synchronize()
    assert fb.LAUNCHES["attention_block_causal" if causal else "attention_block"] == 1
    _within_one_ulp(got.cpu(), fb.attention_block_plain(x, *args, heads=heads,
                                                        causal=causal).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,act_kind", [
    (8, 197, 768, "quick_gelu"), (3, 77, 512, "quick_gelu"), (3, 197, 768, "gelu")])
def test_cuda_mlp_kernel_matches_twin(cuda, b, s, d, act_kind):
    layer = _cuda_layer(d, cuda)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(b, s, d))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    args = [layer["ln_2"]["scale"], layer["ln_2"]["bias"], *layer["mlp"].values()]
    fb.reset_launches()
    got = fb.mlp_block(x, *args, act_kind=act_kind)
    torch.cuda.synchronize()
    assert fb.LAUNCHES["mlp_block"] == 1
    _within_one_ulp(got.cpu(), fb.mlp_block_plain(x, *args, act_kind=act_kind).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True], ids=["image", "text"])
@pytest.mark.parametrize("s", [1, 7, 77, 197, 257, 320])
def test_cuda_attention_core_every_key_bucket(cuda, s, causal):
    """The wgmma core at each key bucket it compiles (32, 80, 200, 256, and
    256 + 64 up to 320 keys), with ragged query tiles."""
    b, d, heads = 2, 512, 8
    layer = _cuda_layer(d, cuda)
    x = torch.from_numpy(np.random.default_rng(s).normal(size=(b, s, d))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    args = [layer["ln_1"]["scale"], layer["ln_1"]["bias"], *layer["attn"].values()]
    fb.reset_launches()
    got = fb.attention_block(x, *args, heads=heads, causal=causal)
    torch.cuda.synchronize()
    assert fb.LAUNCHES["attention_block_causal" if causal else "attention_block"] == 1
    _within_one_ulp(got.cpu(), fb.attention_block_plain(x, *args, heads=heads,
                                                        causal=causal).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("block", ["attention", "mlp_quick_gelu", "mlp_gelu"])
def test_cuda_ragged_m(cuda, block):
    """M = 3 x 77 = 231 rows: not a multiple of the GEMM's 128-row tile."""
    b, s, d = 3, 77, 512
    layer = _cuda_layer(d, cuda)
    x = torch.from_numpy(np.random.default_rng(12).normal(size=(b, s, d))
                         .astype(np.float32)).to(cuda, torch.bfloat16) / 16
    if block == "attention":
        args = [layer["ln_1"]["scale"], layer["ln_1"]["bias"], *layer["attn"].values()]
        got = fb.attention_block(x, *args, heads=8, causal=True)
        want = fb.attention_block_plain(x, *args, heads=8, causal=True)
    else:
        act = block[len("mlp_"):]
        args = [layer["ln_2"]["scale"], layer["ln_2"]["bias"], *layer["mlp"].values()]
        got = fb.mlp_block(x, *args, act_kind=act)
        want = fb.mlp_block_plain(x, *args, act_kind=act)
    torch.cuda.synchronize()
    _within_one_ulp(got.cpu(), want.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("d,heads,f", [(512, 8, 1000), (320, 5, 1280), (200, 2, 808),
                                       (144, 2, 344)])
def test_cuda_gemm_takes_widths_off_its_tiles(cuda, d, heads, f):
    """Widths the GEMMs' tiles do not divide, and head dims other than 64,
    run on the padded operand layout: within one bf16 ulp of the twins."""
    g = torch.Generator().manual_seed(d)
    x = torch.randn(2, 77, d, generator=g).to(cuda, torch.bfloat16)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(cuda)

    mlp = (1 + 0.1 * rn(d), 0.1 * rn(d), rn(d, f, std=d ** -0.5), 0.1 * rn(f),
           rn(f, d, std=f ** -0.5), 0.1 * rn(d))
    attn = (1 + 0.1 * rn(d), 0.1 * rn(d), rn(d, 3 * d, std=d ** -0.5), 0.1 * rn(3 * d),
            rn(d, d, std=d ** -0.5), 0.1 * rn(d))
    _within_one_ulp(fb.mlp_block(x, *mlp).cpu(), fb.mlp_block_plain(x, *mlp).cpu())
    for causal in (False, True):
        _within_one_ulp(fb.attention_block(x, *attn, heads=heads, causal=causal).cpu(),
                        fb.attention_block_plain(x, *attn, heads=heads, causal=causal).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_attention_one_head_of_800(cuda, causal):
    """K1 at one head of 800 (hdp 832): its core in the long route's
    wide-head mode (four output groups, each block both passes), within one
    bf16 ulp of the twin."""
    g = torch.Generator().manual_seed(800)
    d = 800
    x = torch.randn(4, 77, d, generator=g).to(cuda, torch.bfloat16)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(cuda)

    attn = (1 + 0.1 * rn(d), 0.1 * rn(d), rn(d, 3 * d, std=d ** -0.5), 0.1 * rn(3 * d),
            rn(d, d, std=d ** -0.5), 0.1 * rn(d))
    fb.reset_launches()
    got = fb.attention_block(x, *attn, heads=1, causal=causal)
    torch.cuda.synchronize()
    assert fb.LAUNCHES["attention_block_causal" if causal else "attention_block"] == 1
    _within_one_ulp(got.cpu(), fb.attention_block_plain(x, *attn, heads=1, causal=causal).cpu())


@pytest.mark.cuda
def test_cuda_rejects_float32_activations(cuda):
    layer = _cuda_layer(768, cuda)
    x = torch.zeros((1, 197, 768), device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        fb.mlp_block(x, layer["ln_2"]["scale"], layer["ln_2"]["bias"],
                     *layer["mlp"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,heads,causal", [(3, 197, 768, 12, False), (4, 77, 512, 8, True)])
def test_cuda_gradients_flow_through_the_kernels(cuda, b, s, d, heads, causal):
    """The kernel route (forward on the CUDA kernels) gives x and every block
    tensor a gradient, equal to the twin route's on the same card."""
    blk = _port_block(_layer_np(np.random.default_rng(6), d)).to(cuda)
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(b, s, d)).astype(np.float32)
                         ).to(cuda, torch.bfloat16).requires_grad_(True)
    g = torch.randn(b, s, d, device=cuda).to(torch.bfloat16)
    params = [getattr(getattr(blk, grp), k) for grp, k in _PARAM_ORDER]
    fb.reset_launches()
    out = fb.fused_resblock_diff(blk, x, heads, causal=causal)
    got = torch.autograd.grad(out, [x] + params, g)
    assert fb.LAUNCHES["attention_block_causal" if causal else "attention_block"] == 1
    assert fb.LAUNCHES["mlp_block"] == 1
    want = torch.autograd.grad(fb.resblock_plain(x, params, heads, causal=causal),
                               [x] + params, g)
    for a, w in zip(got, want):
        assert a is not None and bool(torch.isfinite(a).all()) and a.abs().max() > 0
        torch.testing.assert_close(a, w, rtol=0, atol=0)


def _cuda_q_block(d, device):
    layer = _cuda_layer(d, device)
    a, m = layer["attn"], layer["mlp"]
    w = {k: quant.QWeight(v) for k, v in (("wqkv", a["wqkv"]), ("wo", a["wo"]),
                                          ("w1", m["w1"]), ("w2", m["w2"]))}
    attn = ((layer["ln_1"]["scale"], layer["ln_1"]["bias"], w["wqkv"].q, w["wqkv"].scale,
             a["bqkv"], w["wo"].q, w["wo"].scale, a["bo"]),
            {"wqkv_qt": w["wqkv"].qt, "wo_qt": w["wo"].qt})
    mlp = ((layer["ln_2"]["scale"], layer["ln_2"]["bias"], w["w1"].q, w["w1"].scale,
            m["b1"], w["w2"].q, w["w2"].scale, m["b2"]),
           {"w1_qt": w["w1"].qt, "w2_qt": w["w2"].qt})
    return attn, mlp


def _kernel_quantizes_its_own_rows(scratch, pairs):
    for codes, rows, scales in pairs:
        q, s = fbq.quant_rows(scratch[rows])
        assert torch.equal(q, scratch[codes]) and torch.equal(s, scratch[scales]), codes


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,heads,causal", [
    (8, 197, 768, 12, False), (3, 197, 768, 12, True), (5, 77, 512, 8, True),
    # the wgmma core's key buckets (32, 80, 200, 256, 256 + 64 keys), both sides
    *[(2, s, 512, 8, causal) for s in (1, 7, 200, 201, 256, 257, 320)
      for causal in (False, True)],
    # B=3 S=77: 231 rows, a ragged M for the s8 GEMM's 128-row tile
    (3, 77, 512, 8, False), (3, 77, 512, 8, True)])
def test_cuda_attention_q_kernel_matches_twin(cuda, b, s, d, heads, causal):
    (args, qkw), _ = _cuda_q_block(d, cuda)
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(b, s, d))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    fbq.reset_launches()
    scratch = {}
    got = fbq.attention_block_q(x, *args, heads=heads, causal=causal, **qkw, scratch=scratch)
    torch.cuda.synchronize()
    assert fbq.LAUNCHES["attention_block_q_causal" if causal else "attention_block_q"] == 1
    _within_one_ulp(got.cpu(), fbq.attention_block_q_plain(x, *args, heads=heads,
                                                           causal=causal).cpu())
    _kernel_quantizes_its_own_rows(scratch, (("xq", "xn", "xs"), ("aq", "attn", "as")))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,act_kind", [
    (8, 197, 768, "quick_gelu"), (3, 77, 512, "quick_gelu"), (3, 197, 768, "gelu"),
    (3, 77, 512, "gelu")])  # B=3 S=77: 231 rows, a ragged M for the s8 GEMM's 128-row tile
def test_cuda_mlp_q_kernel_matches_twin(cuda, b, s, d, act_kind):
    _, (args, qkw) = _cuda_q_block(d, cuda)
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(b, s, d))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    fbq.reset_launches()
    scratch = {}
    got = fbq.mlp_block_q(x, *args, act_kind=act_kind, **qkw, scratch=scratch)
    torch.cuda.synchronize()
    assert fbq.LAUNCHES["mlp_block_q"] == 1
    _within_one_ulp(got.cpu(), fbq.mlp_block_q_plain(x, *args, act_kind=act_kind).cpu())
    _kernel_quantizes_its_own_rows(scratch, (("xq", "xn", "xs"), ("hq", "h", "hs")))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [320, 321, 383, 384, 385, 400, 785])
@pytest.mark.parametrize("block", ["bf16", "int8"])
def test_cuda_attention_core_long_route(cuda, block, s, causal):
    """K1 and K3 past the register core's 320 keys: the long route's packed
    source at a ragged last key tile, both sides of the 128-query block and
    the Frozen-in-Time joint tower's 785 tokens; S = 320 stays short."""
    b, d, heads = 2, 768, 12
    x = torch.from_numpy(np.random.default_rng(s).normal(size=(b, s, d))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    mod = fb if block == "bf16" else fbq
    mod.reset_launches()
    if block == "bf16":
        layer = _cuda_layer(d, cuda)
        args = [layer["ln_1"]["scale"], layer["ln_1"]["bias"], *layer["attn"].values()]
        got = fb.attention_block(x, *args, heads=heads, causal=causal)
        want = fb.attention_block_plain(x, *args, heads=heads, causal=causal)
    else:
        (args, qkw), _ = _cuda_q_block(d, cuda)
        scratch = {}
        got = fbq.attention_block_q(x, *args, heads=heads, causal=causal, **qkw,
                                    scratch=scratch)
        want = fbq.attention_block_q_plain(x, *args, heads=heads, causal=causal)
        _kernel_quantizes_its_own_rows(scratch, (("xq", "xn", "xs"), ("aq", "attn", "as")))
    torch.cuda.synchronize()
    route = fb.core_route(s)
    assert mod.CORE_ROUTES == {"short": int(route == "short"), "long": int(route == "long")}
    _within_one_ulp(got.cpu(), want.cpu())


@pytest.mark.cuda
def test_cuda_q_needs_the_transposed_weights(cuda):
    (args, _), _ = _cuda_q_block(768, cuda)
    x = torch.zeros((1, 197, 768), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="transposed"):
        fbq.attention_block_q(x, *args, heads=12)
