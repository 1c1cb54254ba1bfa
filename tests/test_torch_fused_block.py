"""Fused-block entry points of the PyTorch port (debias_vision_lang_torch/
ops/fused_block.py) against the JAX package's Pallas kernels.

CPU: the port's plain twins against the Pallas kernels run with
``interpret=True`` (as tests/test_fused_block.py runs them) -- float32 at
the JAX package's own fused-vs-XLA bar (atol 2e-5), bfloat16 within one
bf16 ulp of the output's magnitude -- and whole blocks against
``_kernel_math_resblock``.  CUDA (marker ``cuda``, skipped without a card):
the hand-written kernels against the twins at the main path's shapes.

jax is imported inside the JAX-side helpers only, so the CUDA tests run on
a machine without jax:  python -m pytest tests/test_torch_fused_block.py
-m cuda --noconftest -p no:randomly
"""

import math

import numpy as np
import pytest
import torch

from debias_vision_lang_torch.models.layers import ResidualBlock
from debias_vision_lang_torch.ops import fused_block as fb

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
def test_cuda_rejects_float32_activations(cuda):
    layer = _cuda_layer(768, cuda)
    x = torch.zeros((1, 197, 768), device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        fb.mlp_block(x, layer["ln_2"]["scale"], layer["ln_2"]["bias"],
                     *layer["mlp"].values())
