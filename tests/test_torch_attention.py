"""The attention op of the PyTorch port (debias_vision_lang_torch/ops/
attention.py) against the JAX package's (ops/attention.py).

CPU: the twin ``attention_kernel_math`` (what ``attention_pallas`` runs on a
CPU tensor) against the Pallas kernel run with ``interpret=True`` (as
tests/test_attention_kernel.py runs it) and against
``_attention_kernel_math``, forward and backward (``jax.vjp``); float32 at
2e-5 of the largest magnitude (the fused-vs-XLA bar), bfloat16 within one
bf16 ulp for outputs and a cosine of at least 0.9999 for gradients.  S=13
and S=77 (ragged), B*H = 6 (not a multiple of the Pallas group of 8), a
zero mask and CLIP's causal -inf mask.  The towers with ``use_pallas=True``
against the JAX towers at float32 (the same function there).
CUDA (marker ``cuda``, skipped without a card): the hand-written kernel
against the twin at the slice's shapes, and gradients through it.

jax is imported inside the JAX-side helpers only, so the CUDA tests run on
a machine without jax:  python -m pytest tests/test_torch_attention.py
-m cuda --noconftest -p no:randomly
"""

import math

import numpy as np
import pytest
import torch

from debias_vision_lang_torch.models.layers import causal_mask
from debias_vision_lang_torch.ops import attention as A

torch.set_num_threads(1)

B, H, HD = 3, 2, 64  # B*H = 6


def _qkv(s, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, s, HD)).astype(np.float32) for _ in range(3)]


def _mask_np(s, causal):
    return np.triu(np.full((s, s), -np.inf, np.float32), 1) if causal else \
        np.zeros((s, s), np.float32)


def _jnp(a, dtype=None):
    import jax.numpy as jnp

    out = jnp.asarray(a)
    return out if dtype is None else out.astype(dtype)


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np32(t):
    return np.asarray(t.detach().float() if torch.is_tensor(t) else t, np.float32)


def _close_f32(got, ref):
    got, ref = _np32(got), _np32(ref)
    tol = 2e-5 * np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= tol, f"max err {err} > 2e-5 x max |ref| = {tol}"


def _within_one_ulp(got, ref):
    got, ref = _np32(got), _np32(ref)
    ulp = 2.0 ** (math.floor(math.log2(np.abs(ref).max())) - 7)
    err = np.abs(got - ref).max()
    assert err <= ulp, f"max err {err} > 1 bf16 ulp {ulp}"


def _cosine(got, ref):
    got, ref = _np32(got).ravel().astype(np.float64), _np32(ref).ravel().astype(np.float64)
    return float(got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref)))


CASES = [(13, False), (13, True), (77, False), (77, True)]


class TestTwinAgainstJax:
    @pytest.mark.parametrize("s,causal", CASES)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_forward_vs_pallas_interpret(self, s, causal, dtype):
        import jax.numpy as jnp

        from debias_vision_lang_tpu.ops.attention import attention_pallas

        q, k, v = _qkv(s)
        m = _mask_np(s, causal)
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        ref = attention_pallas(*(_jnp(t, jdt) for t in (q, k, v)), _jnp(m),
                               interpret=True)
        got = A.attention_pallas(*(_torch(t, tdt) for t in (q, k, v)), _torch(m))
        assert got.dtype == tdt and got.shape == (B, H, s, HD)
        (_close_f32 if dtype == "float32" else _within_one_ulp)(got, ref)

    @pytest.mark.parametrize("s,causal", CASES)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_forward_vs_kernel_math(self, s, causal, dtype):
        import jax.numpy as jnp

        from debias_vision_lang_tpu.ops.attention import _attention_kernel_math

        q, k, v = _qkv(s, seed=1)
        m = _mask_np(s, causal)
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        ref = _attention_kernel_math(*(_jnp(t, jdt) for t in (q, k, v)), _jnp(m))
        got = A.attention_kernel_math(*(_torch(t, tdt) for t in (q, k, v)), _torch(m))
        (_close_f32 if dtype == "float32" else _within_one_ulp)(got, ref)

    @pytest.mark.parametrize("s,causal", CASES)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_backward_vs_jax_vjp(self, s, causal, dtype):
        import jax
        import jax.numpy as jnp

        from debias_vision_lang_tpu.ops.attention import _attention_kernel_math

        q, k, v = _qkv(s, seed=2)
        g = np.random.default_rng(3).normal(size=q.shape).astype(np.float32)
        m = _mask_np(s, causal)
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        _, vjp = jax.vjp(lambda a, b, c: _attention_kernel_math(a, b, c, _jnp(m)),
                         *(_jnp(t, jdt) for t in (q, k, v)))
        want = vjp(_jnp(g, jdt))
        qkv = [_torch(t, tdt).requires_grad_(True) for t in (q, k, v)]
        out = A.attention(*qkv, _torch(m), use_pallas=True)
        got = torch.autograd.grad(out, qkv, _torch(g, tdt))
        for name, a, b in zip("qkv", got, want):
            assert a.dtype == tdt, name
            if dtype == "float32":
                _close_f32(a, b)
            else:
                assert _cosine(a, b) >= 0.9999, name

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_reference_vs_jax(self, causal, dtype):
        import jax.numpy as jnp

        from debias_vision_lang_tpu.ops.attention import attention_reference

        q, k, v = _qkv(13, seed=4)
        m = _mask_np(13, causal)
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        ref = attention_reference(*(_jnp(t, jdt) for t in (q, k, v)), _jnp(m))
        got = A.attention_reference(*(_torch(t, tdt) for t in (q, k, v)), _torch(m))
        assert got.dtype == tdt
        if dtype == "float32":
            _close_f32(got, ref)
        else:  # bf16 softmax: the two frameworks round the bf16 scores apart
            assert _cosine(got, ref) >= 0.999

    def test_default_dispatch_is_the_reference(self):
        q, k, v = (_torch(t) for t in _qkv(13, seed=5))
        torch.testing.assert_close(A.attention(q, k, v), A.attention_reference(q, k, v),
                                   rtol=0, atol=0)
        torch.testing.assert_close(A.attention(q, k, v, use_pallas=True),
                                   A.attention_kernel_math(q, k, v, torch.zeros(13, 13)),
                                   rtol=0, atol=0)


class TestRouting:
    def test_cpu_twin_does_not_count(self):
        A.reset_launches()
        q, k, v = (_torch(t) for t in _qkv(13))
        A.attention_pallas(q, k, v, causal_mask(13))
        A.attention(q, k, v, use_pallas=True)
        assert A.LAUNCHES == {"attention_pallas": 0}

    def test_other_devices_raise(self):
        q, k, v = (_torch(t).to("meta") for t in _qkv(13))
        with pytest.raises(ValueError, match="cpu .plain twin. or cuda"):
            A.attention_pallas(q, k, v)

    def test_fully_masked_diagonal_free_rows(self):
        """A causal row sees at least its own key, so no row is all -inf."""
        q, k, v = (_torch(t) for t in _qkv(13, seed=6))
        out = A.attention_pallas(q, k, v, causal_mask(13))
        assert bool(torch.isfinite(out).all())
        # the first query attends to the first key only
        torch.testing.assert_close(out[:, :, 0], v[:, :, 0], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The towers with use_pallas=True against the JAX towers
# ---------------------------------------------------------------------------

CTX, VOCAB = 16, 128


@pytest.fixture(scope="module")
def tiny():
    import jax

    from debias_vision_lang_tpu.core.config import (CLIPConfig, DebiasConfig,
                                                    TextConfig, VisionConfig)
    from debias_vision_lang_tpu.models.clip import init_clip_params
    from debias_vision_lang_torch.models.clip import CLIP
    from debias_vision_lang_torch.models.convert import params_from_jax
    from debias_vision_lang_torch.models.debias import DebiasCLIP
    from torch_port_config import port_config

    cfg = CLIPConfig(
        name="tiny",
        vision=VisionConfig(kind="vit", image_size=16, patch_size=8, width=32,
                            layers=2, heads=2, embed_dim=16),
        text=TextConfig(vocab_size=VOCAB, context_length=CTX, width=32, layers=2,
                        heads=2, embed_dim=16))
    params = jax.tree.map(np.array, init_clip_params(jax.random.key(0), cfg))
    dcfg = DebiasConfig(num_debias_tokens=2, hidden_dim=32, max_tokens=CTX)
    tokens = np.random.default_rng(7).normal(size=(2, 32)).astype(np.float32)
    clip = CLIP(port_config(cfg))
    clip.load_state_dict(params_from_jax(params, port_config(cfg)))
    model = DebiasCLIP(clip, torch.from_numpy(tokens.copy()), port_config(dcfg))
    return cfg, dcfg, params, tokens, model


def _text_ids(b=5, seed=8):
    rng = np.random.default_rng(seed)
    ids = np.zeros((b, CTX), np.int32)
    ids[:, 0] = VOCAB - 2
    n = rng.integers(1, 8, b)
    for i in range(b):
        ids[i, 1: 1 + n[i]] = rng.integers(1, 100, n[i])
        ids[i, 1 + n[i]] = VOCAB - 1
    return ids


class TestTowersWithPallas:
    def test_text_tower(self, tiny):
        import jax.numpy as jnp

        from debias_vision_lang_tpu.models.debias import encode_text

        cfg, dcfg, params, tokens, model = tiny
        ids = _text_ids()
        ref = encode_text(params, jnp.asarray(tokens), jnp.asarray(ids), cfg, dcfg,
                          use_pallas=False)
        with torch.no_grad():
            got = model.encode_text(torch.from_numpy(ids).long(), use_pallas=True)
        _close_f32(got, ref)

    def test_image_tower(self, tiny):
        import jax.numpy as jnp

        from debias_vision_lang_tpu.models.clip import encode_image

        cfg, _, params, _, model = tiny
        images = np.random.default_rng(9).normal(size=(4, 16, 16, 3)).astype(np.float32)
        ref = encode_image(params, jnp.asarray(images), cfg, use_pallas=False)
        with torch.no_grad():
            got = model.encode_image(torch.from_numpy(images), use_pallas=True)
        _close_f32(got, ref)

    def test_bf16_with_pallas_skips_the_fused_blocks(self, tiny):
        """use_pallas turns the fused blocks off at every dtype (JAX
        clip.py:142-145): the bf16 tower runs the plain layers with the
        attention op, not the fused-block twins."""
        from debias_vision_lang_torch.models import clip as clip_model

        assert clip_model._use_fused_blocks(torch.bfloat16, use_pallas=True) is False
        assert clip_model._use_fused_blocks(torch.bfloat16) is True
        assert clip_model._use_fused_blocks(torch.float32) is False
        assert clip_model._use_fused_blocks(torch.float32, True, fused=True) is True

    def test_remat_is_the_same_function(self, tiny):
        *_, model = tiny
        ids = torch.from_numpy(_text_ids(seed=10)).long()
        outs = []
        for remat in (False, True):
            model.zero_grad()
            out = model.encode_text(ids, use_pallas=True, remat=remat)
            out.square().sum().backward()
            outs.append((out.detach(), model.debias_tokens.grad.clone()))
        torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
        torch.testing.assert_close(outs[0][1], outs[1][1], rtol=1e-6, atol=1e-7)
        model.zero_grad()


# ---------------------------------------------------------------------------
# CUDA: the hand-written kernel against the twin on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is compiled with nvcc for "
                    "sm_90a and has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cuda_qkv(b, h, s, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, h, s, HD, generator=g).to(device, dtype) for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,causal", [(8, 12, 197, False), (3, 12, 197, True),
                                          (5, 8, 77, True), (2, 2, 13, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_twin(cuda, b, h, s, causal, dtype):
    q, k, v = _cuda_qkv(b, h, s, dtype, cuda, seed=s)
    mask = causal_mask(s, cuda) if causal else torch.randn(s, s, device=cuda)
    A.reset_launches()
    got = A.attention_pallas(q, k, v, mask)
    torch.cuda.synchronize()
    assert A.LAUNCHES["attention_pallas"] == 1 and got.dtype == dtype
    ref = A.attention_kernel_math(q, k, v, mask)
    (_close_f32 if dtype == torch.float32 else _within_one_ulp)(got.cpu(), ref.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_gradients_through_the_kernel(cuda, dtype):
    q, k, v = (t.requires_grad_(True) for t in _cuda_qkv(4, 8, 77, dtype, cuda, seed=1))
    mask = causal_mask(77, cuda)
    g = torch.randn(q.shape, device=cuda).to(dtype)
    A.reset_launches()
    got = torch.autograd.grad(A.attention(q, k, v, mask, use_pallas=True), (q, k, v), g)
    assert A.LAUNCHES["attention_pallas"] == 1
    want = torch.autograd.grad(A.attention_kernel_math(q, k, v, mask), (q, k, v), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_rejects_unsupported_shapes(cuda):
    q = torch.zeros(1, 1, 13, 32, device=cuda)
    with pytest.raises(ValueError, match="head dim 64"):
        A.attention_pallas(q, q, q)
    q = torch.zeros(1, 1, 321, 64, device=cuda)
    with pytest.raises(ValueError, match="320"):
        A.attention_pallas(q, q, q)
