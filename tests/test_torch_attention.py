"""The attention op of the PyTorch port (debias_vision_lang_torch/ops/
attention.py) against the JAX package's (ops/attention.py).

CPU: the twin ``attention_kernel_math`` (what ``attention_pallas`` runs on a
CPU tensor) against the Pallas kernel run with ``interpret=True`` (as
tests/test_attention_kernel.py runs it) and against
``_attention_kernel_math``, forward and backward (``jax.vjp``); float32 at
2e-5 of the largest magnitude (the fused-vs-XLA bar), bfloat16 within one
bf16 ulp for outputs and a cosine of at least 0.9999 for gradients.  S=13
and S=77 (ragged), B*H = 6 (not a multiple of the Pallas group of 8), a
zero mask and CLIP's causal -inf mask; the long route's shapes (S = 321
and 785, head dims 32, 80 and 128) likewise, the route each shape takes
(``_plan``), the long route's head-dim and mask padding, and a numpy
emulation of the long route's two-pass arithmetic (per-tile rescaled row
sum, scores recomputed in pass 2, P V accumulated per 64-key tile, 3xTF32
products at float32) against the Pallas kernel at the long shapes, S = 1025
and head dim 192.  The towers with ``use_pallas=True`` against the JAX
towers at float32 (the same function there).  CUDA (marker ``cuda``,
skipped without a card): the hand-written kernels against the twin at the
slice's shapes and the long route's, the launches per route, and gradients
through them.

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
        q, k, v = (_torch(t) for t in _qkv(321))  # a long-route shape
        A.attention_pallas(q, k, v)
        assert A.LAUNCHES == {"attention_pallas": 0, "attention_pallas_long": 0}

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
# The long route: S > 320 or a head dim other than 64
# ---------------------------------------------------------------------------

LONG_CASES = [(321, 64), (785, 64), (77, 32), (321, 80), (77, 128), (785, 32)]


class TestLongRoute:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("s,hd", LONG_CASES)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_forward_vs_pallas_interpret(self, s, hd, causal, dtype):
        """The Pallas kernel pads S and the head dim (to 128 lanes) itself;
        the twin runs at the unpadded shape."""
        import jax.numpy as jnp

        from debias_vision_lang_tpu.ops.attention import attention_pallas

        rng = np.random.default_rng(s + hd)
        q, k, v = (rng.normal(size=(B, H, s, hd)).astype(np.float32) for _ in range(3))
        m = _mask_np(s, causal)
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        ref = attention_pallas(*(_jnp(t, jdt) for t in (q, k, v)), _jnp(m),
                               interpret=True)
        got = A.attention_pallas(*(_torch(t, tdt) for t in (q, k, v)), _torch(m))
        assert got.dtype == tdt and got.shape == (B, H, s, hd)
        (_close_f32 if dtype == "float32" else _within_one_ulp)(got, ref)

    @pytest.mark.parametrize("s,hd,route", [
        (1, 64, "short"), (77, 64, "short"), (320, 64, "short"), (321, 64, "long"),
        (785, 64, "long"), (77, 32, "long"), (197, 80, "long"), (320, 128, "long"),
        (1, 63, "long"), (4096, 16, "long")])
    def test_plan_is_long_exactly_past_320_keys_or_off_head_dim_64(self, s, hd, route):
        assert A._plan(s, hd) == route

    @pytest.mark.parametrize("hd,hdp", [(1, 64), (32, 64), (64, 64), (80, 128), (128, 128),
                                        (130, 192)])
    def test_padded_head_dim(self, hd, hdp):
        assert A._padded_head_dim(hd) == hdp

    @pytest.mark.parametrize("s", [1, 63, 64, 65, 321, 785])
    def test_long_route_mask_pads_columns_to_64_with_minus_inf(self, s):
        """The kernel reads the mask in 64-key tiles through a TMA map and
        tests no key index: the columns past S carry -inf."""
        mask = torch.randn(s, s, generator=torch.Generator().manual_seed(s))
        got = A._long_route_mask(mask)
        assert got.shape == (s, 64 * -(-s // 64)) and got.is_contiguous()
        assert torch.equal(got[:, :s], mask)
        assert bool((got[:, s:] == -math.inf).all())

    @pytest.mark.parametrize("s", [77, 321])
    @pytest.mark.parametrize("hd", [32, 80, 128])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_head_dim_padding_gives_the_twin_exactly(self, s, hd, dtype):
        """Zero columns up to a multiple of 64 with the original head dim's
        scale: the same output, bit for bit, once the columns are cut."""
        rng = np.random.default_rng(hd)
        q, k, v = (_torch(rng.normal(size=(2, 3, s, hd)), dtype) for _ in range(3))
        mask = _torch(rng.normal(size=(s, s)))
        hdp = A._padded_head_dim(hd)
        padded = [A._pad_head_dim(t, hdp) for t in (q, k, v)]
        assert padded[0].shape == (2, 3, s, hdp)
        assert bool((padded[0][..., hd:] == 0).all())
        got = A.attention_kernel_math(*padded, mask, scale=1 / math.sqrt(hd))
        assert bool((got[..., hd:] == 0).all())
        torch.testing.assert_close(got[..., :hd], A.attention_kernel_math(q, k, v, mask),
                                   rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The float32 route's arithmetic: 3xTF32, emulated in numpy
# ---------------------------------------------------------------------------


def _tf32(x):
    """cvt.rna.tf32.f32 on the float32 bit pattern: round the 13 low
    mantissa bits to nearest, ties away from zero, and clear them."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _mm_3xtf32(a, b):
    """a @ b with each product as big*big + big*small + small*big of the
    TF32 halves (big = tf32(x), small = tf32(x - big)), summed in f32: the
    kernel's mma.sync order, cross terms first."""
    ab, bb = _tf32(a), _tf32(b)
    asm, bsm = _tf32(a - ab), _tf32(b - bb)
    return (asm @ bb + ab @ bsm) + ab @ bb


def _mm_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


def _attention_emulated(q, k, v, mask, mm):
    """The kernel's float32 function with both products through ``mm``:
    scores * scale + mask, row max, exp, row sum and division in f32."""
    s = mm(q, np.swapaxes(k, -1, -2)) * np.float32(1 / 8) + mask
    e = np.exp(s - s.max(-1, keepdims=True))
    return mm(e / e.sum(-1, keepdims=True), v)


def _emu_inputs(s, kind, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(2, 2, s, HD)).astype(np.float32) for _ in range(3))
    mask = {"zero": lambda: np.zeros((s, s), np.float32),
            "random": lambda: rng.normal(size=(s, s)).astype(np.float32),
            "causal": lambda: _mask_np(s, True)}[kind]()
    return q, k, v, mask


class TestSplitTf32:
    """Why the float32 route runs three TF32 products per f32 product."""

    @pytest.mark.parametrize("kind", ["zero", "random", "causal"])
    @pytest.mark.parametrize("s", [1, 7, 77, 197, 257, 320])
    def test_3xtf32_meets_the_f32_bar(self, s, kind):
        q, k, v, mask = _emu_inputs(s, kind, seed=s)
        got = _attention_emulated(q, k, v, mask, _mm_3xtf32)
        ref = A.attention_kernel_math(*(_torch(t) for t in (q, k, v)), _torch(mask))
        _close_f32(got, ref)

    def test_single_tf32_misses_it(self):
        q, k, v, mask = _emu_inputs(197, "random", seed=197)
        got = _attention_emulated(q, k, v, mask, _mm_1xtf32)
        ref = A.attention_kernel_math(*(_torch(t) for t in (q, k, v)), _torch(mask))
        with pytest.raises(AssertionError, match="max err"):
            _close_f32(got, ref)

    def test_tf32_rounding(self):
        x = np.array([1.0, 1 + 2.0 ** -11, 1 + 2.0 ** -10 + 2.0 ** -11, -(1 + 2.0 ** -11),
                      1 + 2.0 ** -12], np.float32)
        # ties go away from zero; the result keeps 10 mantissa bits
        np.testing.assert_array_equal(_tf32(x), np.array(
            [1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -9, -(1 + 2.0 ** -10), 1.0], np.float32))
        big = _tf32(x)
        np.testing.assert_array_equal(big + _tf32(x - big), x)


# ---------------------------------------------------------------------------
# The long route's arithmetic: two passes over 64-key tiles, emulated in numpy
# ---------------------------------------------------------------------------

LONG_TILE = 64


def _round_to(x, dtype):
    """Round float32 values to ``dtype`` (float32 or bfloat16), as float32."""
    if dtype == "float32":
        return np.asarray(x, np.float32)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _long_scores(q, k, mask, k0, scale, mm):
    """One key tile's scores as the kernel forms them: the products, then
    fmul by the scale and fadd of the mask, each rounded to f32."""
    s = mm(q, np.swapaxes(k[..., k0:k0 + LONG_TILE, :], -1, -2))
    return s * np.float32(scale) + mask[:, k0:k0 + LONG_TILE]


def _long_row_stats(q, k, mask, scale, mm):
    """Pass 1: the row max m and the per-tile rescaled row sum l =
    l * exp(m_old - m_new) + sum(exp(s - m_new))."""
    shape = q.shape[:-1] + (1,)
    m = np.full(shape, -np.inf, np.float32)
    l = np.zeros(shape, np.float32)
    for k0 in range(0, k.shape[-2], LONG_TILE):
        s = _long_scores(q, k, mask, k0, scale, mm)
        m_new = np.maximum(m, s.max(-1, keepdims=True))
        with np.errstate(invalid="ignore"):
            l = l * np.where(m == -np.inf, np.float32(0), np.exp(m - m_new))
        l = l + np.exp(s - m_new).sum(-1, keepdims=True, dtype=np.float32)
        m = m_new
    return m, l


def _long_route_emulated(q, k, v, mask, dtype, scale=None):
    """The long route's function on float32 arrays that hold ``dtype``
    values: the head dim zero-padded to a multiple of 64 with the original
    head dim's scale; pass 1 (``_long_row_stats``); pass 2 recomputes each
    tile's scores, p = exp(s - m) * (1 / l) rounded to ``dtype``, and
    accumulates p V per 64-key tile in f32; one output rounding.  float32
    runs both products as 3xTF32 (``_mm_3xtf32``)."""
    hd = q.shape[-1]
    scale = 1 / math.sqrt(hd) if scale is None else scale
    hdp = A._padded_head_dim(hd)
    q, k, v = (np.pad(t, [(0, 0)] * (t.ndim - 1) + [(0, hdp - hd)]) for t in (q, k, v))
    mm = _mm_3xtf32 if dtype == "float32" else np.matmul
    m, l = _long_row_stats(q, k, mask, scale, mm)
    inv = np.float32(1) / l
    o = np.zeros(q.shape, np.float32)
    for k0 in range(0, k.shape[-2], LONG_TILE):
        p = _round_to(np.exp(_long_scores(q, k, mask, k0, scale, mm) - m) * inv, dtype)
        o = o + mm(p, v[..., k0:k0 + LONG_TILE, :])
    return _round_to(o, dtype)[..., :hd]


LONG_EMU_CASES = LONG_CASES + [(1025, 64), (321, 192)]
LONG_ROWS = 128  # query rows per block of the bf16 long route (2 warpgroups of 64)


def _packed_long_route_emulated(qkv, b, s, heads, causal, dtype, *, key_test=True,
                                causal_row="image"):
    """The long route on K1 / K3's packed source: qkv [B*S, 3D] read through
    a 3-d map over [3D, S, B] -- head h's q, k and v at columns 64h, D + 64h
    and 2D + 64h, rows ending at the image's S (the last query block and the
    last key tile read zeros past it) -- and attn [B*S, D] written at column
    64h; the scores s * scale, -inf for a key past S or, when causal, past
    the query's row in its image (q0 + the row in the block).  The two
    passes per block are ``_long_route_emulated``'s.  ``key_test=False``
    and ``causal_row="block"`` emulate two faults the kernel must not have:
    the zero-filled keys past S left unmasked (a zero score is no -inf),
    and the causal test against the row within the block."""
    d = heads * HD
    nk = -(-s // LONG_TILE) * LONG_TILE
    out = np.zeros((b * s, d), np.float32)
    for img in range(b):
        lo = img * s
        rows = np.zeros((nk + LONG_ROWS, 3 * d), np.float32)
        rows[:s] = qkv[lo:lo + s]
        for h in range(heads):
            k = rows[:nk, d + h * HD:d + (h + 1) * HD]
            v = rows[:nk, 2 * d + h * HD:2 * d + (h + 1) * HD]
            for q0 in range(0, s, LONG_ROWS):
                q = rows[q0:q0 + LONG_ROWS, h * HD:(h + 1) * HD]
                key = np.arange(nk)[None, :]
                row = (q0 if causal_row == "image" else 0) + np.arange(LONG_ROWS)[:, None]
                keep = ((key < s) | (not key_test)) & ((not causal) | (key <= row))
                mask = np.where(keep, 0.0, -np.inf).astype(np.float32)
                o = _long_route_emulated(q, k, v, mask, dtype, scale=1 / 8)
                n = min(LONG_ROWS, s - q0)
                out[lo + q0:lo + q0 + n, h * HD:(h + 1) * HD] = o[:n]
    return out


def _wide_route_emulated(q, k, v, mask, dtype, scale=None):
    """The long route's wide-head mode (hdp past 192): the row max m and
    sum l once (the statistics launch, ``_long_row_stats``), then each
    output group of ``A._wide_groups`` recomputes every key tile's scores,
    p = exp(s - m) * (1 / l) rounded to ``dtype``, and accumulates p V over
    its own 64-dim chunks per 64-key tile in f32; one output rounding."""
    hd = q.shape[-1]
    scale = 1 / math.sqrt(hd) if scale is None else scale
    hdp = A._padded_head_dim(hd)
    q, k, v = (np.pad(t, [(0, 0)] * (t.ndim - 1) + [(0, hdp - hd)]) for t in (q, k, v))
    mm = _mm_3xtf32 if dtype == "float32" else np.matmul
    m, l = _long_row_stats(q, k, mask, scale, mm)
    inv = np.float32(1) / l
    o = np.zeros(q.shape, np.float32)
    for c0, c1 in A._wide_groups(hdp):
        cols = slice(c0 * LONG_TILE, c1 * LONG_TILE)
        for k0 in range(0, k.shape[-2], LONG_TILE):
            p = _round_to(np.exp(_long_scores(q, k, mask, k0, scale, mm) - m) * inv, dtype)
            o[..., cols] = o[..., cols] + mm(p, v[..., k0:k0 + LONG_TILE, cols])
    return _round_to(o, dtype)[..., :hd]


def _packed_wide_emulated(qkv, b, s, hd, causal):
    """The wide-head mode on K1 / K3's packed source at one head: qkv [B*S,
    3 hdp] (q, k, v at columns 0, hdp, 2 hdp, zero past hd), 64-query blocks
    whose rows end at the image's S, the scores s * hd^-0.5, -inf for a key
    past S or, when causal, past the query's row in its image."""
    hdp = A._padded_head_dim(hd)
    nk = -(-s // LONG_TILE) * LONG_TILE
    out = np.zeros((b * s, hdp), np.float32)
    for img in range(b):
        rows = np.zeros((nk + LONG_TILE, 3 * hdp), np.float32)
        rows[:s] = qkv[img * s:(img + 1) * s]
        k, v = rows[:nk, hdp:2 * hdp], rows[:nk, 2 * hdp:]
        for q0 in range(0, s, LONG_TILE):
            key = np.arange(nk)[None, :]
            row = q0 + np.arange(LONG_TILE)[:, None]
            keep = (key < s) & ((not causal) | (key <= row))
            mask = np.where(keep, 0.0, -np.inf).astype(np.float32)
            o = _wide_route_emulated(rows[q0:q0 + LONG_TILE, :hdp], k, v, mask, "bfloat16",
                                     scale=1 / math.sqrt(hd))
            n = min(LONG_TILE, s - q0)
            out[img * s + q0:img * s + q0 + n] = o[:n]
    return out[:, :hd]


WIDE_EMU_CASES = [(s, hd) for hd in (193, 256, 800) for s in (63, 64, 65, 77, 321)]


def _packed_inputs(s, seed, b=2, heads=2):
    rng = np.random.default_rng(seed)
    return _round_to(rng.normal(size=(b * s, 3 * heads * HD)), "bfloat16")


class TestLongRouteEmulated:
    """The two-pass arithmetic of ``csrc/attention_long.cuh::
    attention_long_kernel`` against the JAX kernel: within 2e-5 of the
    largest magnitude at float32 (3xTF32 products), one bf16 ulp at
    bfloat16; and on K1 / K3's packed source against their core's twin."""

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("s,hd", LONG_EMU_CASES)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_two_pass_vs_pallas_interpret(self, s, hd, causal, dtype):
        import jax.numpy as jnp

        from debias_vision_lang_tpu.ops.attention import attention_pallas

        rng = np.random.default_rng(s + hd + 1)
        q, k, v = (_round_to(rng.normal(size=(B, H, s, hd)), dtype) for _ in range(3))
        m = _mask_np(s, causal)
        ref = attention_pallas(*(_jnp(t, getattr(jnp, dtype)) for t in (q, k, v)), _jnp(m),
                               interpret=True)
        got = _long_route_emulated(q, k, v, m, dtype)
        assert got.shape == (B, H, s, hd)
        (_close_f32 if dtype == "float32" else _within_one_ulp)(got, ref)

    @pytest.mark.parametrize("kind", ["random", "causal"])
    @pytest.mark.parametrize("s", [321, 785, 1025])
    def test_rescaled_sum_is_the_plain_sum(self, s, kind):
        """Only the order of the f32 row sum differs from the twin's: within
        a relative 1e-6 of exp(s - max) summed over the whole row."""
        q, k, _, mask = _emu_inputs(s, kind, seed=s + 2)
        m, l = _long_row_stats(q, k, mask, 1 / 8, np.matmul)
        scores = np.concatenate([_long_scores(q, k, mask, k0, 1 / 8, np.matmul)
                                 for k0 in range(0, s, LONG_TILE)], -1)
        m_plain = scores.max(-1, keepdims=True)
        l_plain = np.exp(scores - m_plain).sum(-1, keepdims=True, dtype=np.float32)
        np.testing.assert_array_equal(m, m_plain)
        rel = np.abs(l - l_plain) / l_plain
        assert rel.max() <= 1e-6, f"rescaled sum off by {rel.max()} of the plain sum"

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("s", [321, 785])
    def test_packed_source_is_the_k1_k3_twin(self, s, causal):
        """K1 / K3's long route (``attention_long_kernel<bf16, 1, true>``)
        against their core's twin ``fused_block.attention_core``: within
        one bf16 ulp, 2 images x 2 heads."""
        from debias_vision_lang_torch.ops import fused_block as fb

        b, heads = 2, 2
        qkv = _packed_inputs(s, seed=s + causal)
        got = _packed_long_route_emulated(qkv, b, s, heads, causal, "bfloat16")
        ref = fb.attention_core(torch.from_numpy(qkv.reshape(b, s, -1)).to(torch.bfloat16),
                                heads, causal)
        _within_one_ulp(got, ref.float().reshape(b * s, -1).numpy())

    @pytest.mark.parametrize("fault,causal", [({"key_test": False}, False),
                                              ({"causal_row": "block"}, True)])
    @pytest.mark.parametrize("s", [321, 785])
    def test_packed_source_pins_the_key_bound_and_causal_rule(self, s, fault, causal):
        """Keys past the image's S left unmasked, or the causal test against
        the row within the block, give another function: the emulation
        above pins both."""
        from debias_vision_lang_torch.ops import fused_block as fb

        b, heads = 2, 2
        qkv = _packed_inputs(s, seed=s + 7)
        got = _packed_long_route_emulated(qkv, b, s, heads, causal, "bfloat16", **fault)
        ref = fb.attention_core(torch.from_numpy(qkv.reshape(b, s, -1)).to(torch.bfloat16),
                                heads, causal)
        with pytest.raises(AssertionError, match="max err"):
            _within_one_ulp(got, ref.float().reshape(b * s, -1).numpy())

    def test_packed_head_columns(self):
        """Head h reads q, k, v at columns 64h, D + 64h, 2D + 64h and writes
        column 64h: with one head's v set to a constant, only that head's
        output columns hold it."""
        b, s, heads = 1, 321, 2
        qkv = _packed_inputs(s, seed=3, b=b, heads=heads)
        d = heads * HD
        qkv[:, 2 * d + HD:2 * d + 2 * HD] = 0.5  # head 1's v
        got = _packed_long_route_emulated(qkv, b, s, heads, False, "bfloat16")
        np.testing.assert_array_equal(got[:, HD:], np.full((s, HD), 0.5, np.float32))
        assert np.abs(got[:, :HD] - 0.5).min() > 0

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("s,hd", WIDE_EMU_CASES)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_wide_mode_vs_pallas_interpret(self, s, hd, causal, dtype):
        """The wide-head mode's order (statistics once, output groups of at
        most four 64-dim chunks) against the JAX kernel, which holds the
        whole head: 2e-5 of the largest magnitude at float32 (3xTF32), one
        bf16 ulp at bfloat16; a random mask or CLIP's causal one."""
        import jax.numpy as jnp

        from debias_vision_lang_tpu.ops.attention import attention_pallas

        rng = np.random.default_rng(s * hd + causal)
        q, k, v = (_round_to(rng.normal(size=(1, 2, s, hd)), dtype) for _ in range(3))
        m = _mask_np(s, True) if causal else rng.normal(size=(s, s)).astype(np.float32)
        ref = attention_pallas(*(_jnp(t, getattr(jnp, dtype)) for t in (q, k, v)), _jnp(m),
                               interpret=True)
        got = _wide_route_emulated(q, k, v, m, dtype)
        assert got.shape == (1, 2, s, hd)
        (_close_f32 if dtype == "float32" else _within_one_ulp)(got, ref)

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("s,hd", WIDE_EMU_CASES)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_wide_mode_vs_twin(self, s, hd, causal, dtype):
        """The same emulation against the port's twin at the same bars."""
        rng = np.random.default_rng(s * hd + causal + 1)
        q, k, v = (_round_to(rng.normal(size=(1, 2, s, hd)), dtype) for _ in range(3))
        m = _mask_np(s, True) if causal else rng.normal(size=(s, s)).astype(np.float32)
        tdt = getattr(torch, dtype)
        ref = A.attention_kernel_math(*(_torch(t, tdt) for t in (q, k, v)), _torch(m))
        got = _wide_route_emulated(q, k, v, m, dtype)
        (_close_f32 if dtype == "float32" else _within_one_ulp)(got, ref)

    @pytest.mark.parametrize("hdp", range(192, 833, 64))
    def test_wide_groups_cover_every_chunk_once(self, hdp):
        """The output groups cover the cq = hdp / 64 chunks in order, each
        once, with at most four chunks a group, in ceil(cq / 4) groups whose
        sizes differ by at most one."""
        cq = hdp // LONG_TILE
        groups = A._wide_groups(hdp)
        assert [c for c0, c1 in groups for c in range(c0, c1)] == list(range(cq))
        sizes = [c1 - c0 for c0, c1 in groups]
        assert len(groups) == -(-cq // A.WIDE_GROUP) and max(sizes) <= A.WIDE_GROUP
        assert max(sizes) - min(sizes) <= 1

    @pytest.mark.parametrize("s,hd,f32,want", [
        (77, 192, True, 0), (77, 256, False, 0), (785, 800, False, 8 * 6 * 785),
        (77, 256, True, 4 * 6 * 256 * (2 * 77 + 128) * 2),
        (785, 800, True, 4 * 6 * 832 * (2 * 785 + 832) * 2 + 8 * 6 * 785)])
    def test_wide_workspace_bytes(self, s, hd, f32, want):
        """The wrapper's workspace: the float32 halves of Q, K and V^T (keys
        rounded up to 64), and the row statistics with more than one output
        group; nothing at head dims the resident blocks take."""
        assert A._wide_workspace_bytes(6, s, A._padded_head_dim(hd), f32) == want

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("s", [77, 321])
    def test_packed_wide_mode_is_the_k1_twin(self, s, causal):
        """K1 / K3's packed source in the wide-head mode at one head of 256
        (hdp 256: one group of four chunks, each block both passes) against
        their core's twin ``fused_block.attention_core``: one bf16 ulp."""
        from debias_vision_lang_torch.ops import fused_block as fb

        b, hd = 2, 256
        qkv = _round_to(np.random.default_rng(s + causal).normal(size=(b * s, 3 * hd)),
                        "bfloat16")
        got = _packed_wide_emulated(qkv, b, s, hd, causal)
        ref = fb.attention_core(torch.from_numpy(qkv.reshape(b, s, -1)).to(torch.bfloat16), 1,
                                causal)
        _within_one_ulp(got, ref.float().reshape(b * s, -1).numpy())

    @pytest.mark.parametrize("s", [1, 63, 64, 65, 383, 384, 385])
    def test_emulation_at_tile_edges_is_the_twin(self, s):
        """A ragged last tile, and the 127/128/129-query block edges."""
        q, k, v, mask = _emu_inputs(s, "random", seed=s + 3)
        got = _long_route_emulated(q, k, v, mask, "float32")
        ref = A.attention_kernel_math(*(_torch(t) for t in (q, k, v)), _torch(mask))
        _close_f32(got, ref)


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
@pytest.mark.parametrize("b,h,s,causal", [
    (8, 12, 197, False), (3, 12, 197, True), (5, 8, 77, True), (2, 2, 13, False),
    (3, 5, 197, False),  # B*H = 15
    # both sides of every key bucket (32, 80, 200, 256, 320 keys)
    *[(2, 8, s, causal) for s in (1, 7, 32, 33, 80, 81, 200, 201, 256, 257, 320)
      for causal in (False, True)]])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_twin(cuda, b, h, s, causal, dtype):
    q, k, v = _cuda_qkv(b, h, s, dtype, cuda, seed=s)
    mask = causal_mask(s, cuda) if causal else torch.randn(s, s, device=cuda)
    A.reset_launches()
    got = A.attention_pallas(q, k, v, mask)
    torch.cuda.synchronize()
    assert A.LAUNCHES == {"attention_pallas": 1, "attention_pallas_long": 0}
    assert got.dtype == dtype
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
@pytest.mark.parametrize("b,h,s,hd,kind", [
    *[(2, 8, s, 64, kind) for s in (321, 400, 785) for kind in ("zero", "random", "causal")],
    *[(2, 8, s, hd, "random") for s in (77, 197) for hd in (32, 80, 128)],
    (3, 5, 785, 64, "random"),
    # the 127 / 128 / 129-query block edges, 17 key tiles, head dim 192
    *[(2, 8, s, 64, kind) for s in (383, 384, 385, 1025) for kind in ("random", "causal")],
    *[(2, 8, s, 192, "random") for s in (77, 785)]])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_long_route_matches_twin(cuda, b, h, s, hd, kind, dtype):
    """S past 320 or a head dim other than 64: the long route, and only it."""
    g = torch.Generator().manual_seed(s + hd)
    q, k, v = (torch.randn(b, h, s, hd, generator=g).to(cuda, dtype) for _ in range(3))
    mask = {"zero": lambda: torch.zeros(s, s, device=cuda),
            "random": lambda: torch.randn(s, s, device=cuda),
            "causal": lambda: causal_mask(s, cuda)}[kind]()
    A.reset_launches()
    got = A.attention_pallas(q, k, v, mask)
    torch.cuda.synchronize()
    assert A.LAUNCHES == {"attention_pallas": 0, "attention_pallas_long": 1}
    assert got.dtype == dtype and got.shape == q.shape
    ref = A.attention_kernel_math(q, k, v, mask)
    (_close_f32 if dtype == torch.float32 else _within_one_ulp)(got.cpu(), ref.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("s", [400, 785])
def test_cuda_long_route_large_scores(cuda, s):
    """Every score shifted by 1e6 (softmax is shift-invariant): the bf16
    long route's exp takes the f32 difference s - max first, so nothing
    cancels against the large max."""
    g = torch.Generator().manual_seed(s)
    q, k, v = (torch.randn(2, 4, s, 64, generator=g).to(cuda, torch.bfloat16) for _ in range(3))
    mask = torch.randn(s, s, device=cuda) + 1e6
    got = A.attention_pallas(q, k, v, mask)
    ref = A.attention_kernel_math(q, k, v, mask)
    assert bool(torch.isfinite(got).all())
    _within_one_ulp(got.cpu(), ref.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,hd,kind", [
    *[(2, 3, s, hd, "random") for s, hd in ((77, 193), (77, 256), (785, 256), (77, 800),
                                            (321, 800))],
    (2, 3, 785, 256, "causal"), (2, 3, 321, 800, "causal"),
    # a Frozen-in-Time joint tower's batch and heads
    (8, 12, 785, 256, "random"), (8, 12, 785, 800, "random")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_takes_head_dims_past_192(cuda, b, h, s, hd, kind, dtype):
    """Past 192 padded dims the long route's wide-head mode (output groups
    of at most four 64-dim chunks, the row statistics once): the long
    route's launch, the float32 pre-pass and the statistics launch counted
    where they run, the twin's bars."""
    g = torch.Generator().manual_seed(s + hd)
    q, k, v = (torch.randn(b, h, s, hd, generator=g).to(cuda, dtype) for _ in range(3))
    mask = causal_mask(s, cuda) if kind == "causal" else torch.randn(s, s, device=cuda)
    A.reset_launches()
    got = A.attention_pallas(q, k, v, mask)
    torch.cuda.synchronize()
    assert A.LAUNCHES == {"attention_pallas": 0, "attention_pallas_long": 1}
    groups = len(A._wide_groups(A._padded_head_dim(hd)))
    assert A.WIDE_LAUNCHES == {"split_tf32": int(dtype == torch.float32),
                               "row_stats": int(groups > 1)}
    assert got.dtype == dtype and got.shape == q.shape
    ref = A.attention_kernel_math(q, k, v, mask)
    (_close_f32 if dtype == torch.float32 else _within_one_ulp)(got.cpu(), ref.cpu())
