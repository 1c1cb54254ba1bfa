"""The port's kernels' twins at the shapes the card's kernels used to refuse,
against the JAX package (debias_vision_lang_torch/ops/ against
debias_vision_lang_tpu/ops/ and the KB bodies of benchmarks/).

  * K5 (``attention_pallas``) past head dim 192 (193, 256, 800): the twin
    against JAX's ``attention_pallas`` in interpret mode (it pads the head
    dim to 128 lanes itself), float32 at 2e-5 of the largest magnitude and
    bfloat16 within one bf16 ulp (tests/test_torch_attention.py's bars);
    the card's route is the long one and pads to a multiple of 64.
  * KB (a) 1's int8 core past 256 keys and off head dim 64: the block
    against ``benchmarks/attn_int8_cores.py::attention_block_qq`` in
    interpret mode at S = 257 and 400 and head dim 80 (the per-row
    full-width bars of tests/kb_helpers.py); the twin's p row amax is 1 /
    its row sum exactly (the tiled route's scale); a torch emulation of the
    tiled route's two passes (64-key tiles, the rescaled row sum, p from the
    final max and sum, int32 P V over every tile, one f32 conversion)
    against the twin.
  * The KB entries off the registry widths, at D = 200 (H = 2, head dim
    100) and head dim 72 (D = 144, H = 2): KB (a) 5 ``attention_block_opt``
    and KB (a) 6 ``attention_block_hgrid`` against attn_variants.py's
    functions (float32 at 1e-4 / 2e-5, bfloat16 one ulp), KB (a) 1 against
    attn_int8_cores.py's, and the MLP bodies (KB (a) 2's ``pipe_kernel``,
    KB (a) 3's ``mlp_q_kernel_var``, both captured from their scripts'
    ``main()``; shape-generic) at D = 200, F = 800.  The attention closures
    of q_kernel_variants.py, q_ilp4.py, q_attribution.py and
    q_layer_fused.py read ViT-B/16's width from their enclosing ``main()``,
    so at other widths only their twins run (tests/test_torch_kb_*.py hold
    them to the closures at that width).
"""

import functools
import math
import pathlib

import numpy as np
import pytest
import torch

from debias_vision_lang_torch.ops import attention as A
from debias_vision_lang_torch.ops import fused_block as fb
from debias_vision_lang_torch.ops import fused_block_q as fbq
from kb_helpers import _jnp, _layer, _np32, _pallas_ops, _t, _x, capture, check
from kb_helpers import interpret as _interpret
from kb_helpers import load as _load
from kb_helpers import within_one_ulp

torch.set_num_threads(1)

OFF_REGISTRY = [(200, 2), (144, 2)]  # (D, H): head dims 100 and 72


def _close_f32(got, ref, rel=2e-5):
    got, ref = _np32(got), _np32(ref)
    tol = rel * np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= tol, f"max err {err} > {tol}"


# ---------------------------------------------------------------------------
# K5 past head dim 192
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd", [193, 256, 800])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_twin_matches_pallas_past_head_dim_192(hd, causal, dtype):
    import jax.numpy as jnp

    from debias_vision_lang_tpu.ops.attention import attention_pallas

    s = 77
    rng = np.random.default_rng(hd)
    q, k, v = (rng.normal(size=(1, 2, s, hd)).astype(np.float32) for _ in range(3))
    m = (np.triu(np.full((s, s), -np.inf, np.float32), 1) if causal
         else rng.normal(size=(s, s)).astype(np.float32))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = attention_pallas(*(_jnp(t, jdt) for t in (q, k, v)), _jnp(m), interpret=True)
    got = A.attention_pallas(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)),
                             torch.from_numpy(m))
    assert got.dtype == tdt and got.shape == (1, 2, s, hd)
    (_close_f32 if dtype == "float32" else within_one_ulp)(got, ref)
    assert A._plan(s, hd) == "long" and A._padded_head_dim(hd) == 64 * -(-hd // 64)


# ---------------------------------------------------------------------------
# KB (a) 1's int8 core at any key count and head dim
# ---------------------------------------------------------------------------


@pytest.fixture
def int8_cores(monkeypatch):
    mod = _load("attn_int8_cores")
    monkeypatch.setattr(mod.pl, "pallas_call",
                        functools.partial(mod.pl.pallas_call, interpret=True))
    return mod


@pytest.mark.parametrize("s,d,heads", [(257, 128, 2), (400, 128, 2), (77, 160, 2),
                                       (257, 160, 2), *[(77, d, h) for d, h in OFF_REGISTRY]])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qq_block_matches_the_pallas_kernel_off_its_register_route(int8_cores, s, d, heads,
                                                                    dtype):
    import jax.numpy as jnp

    attn, _ = _layer(d, seed=s)
    x = _x(1, s, d, seed=d)
    ref = int8_cores.attention_block_qq(_jnp(x, getattr(jnp, dtype)), *map(_jnp, attn),
                                        heads=heads)
    got = fbq.attention_block_qq(_t(x, getattr(torch, dtype)), *map(_t, attn), heads=heads)
    check(got, ref, dtype, full_width=True)


def _scores(qkv32, heads, h):
    q, k, _ = fb._head_qkv(qkv32, heads, h)
    hd = q.shape[-1]
    qq, qsc = fbq.quant_rows(q)
    kq, ksc = fbq.quant_rows(k)
    return fbq._bmm_exact(qq, kq.transpose(1, 2)).float() * qsc * ksc.transpose(1, 2) \
        * (1.0 / hd ** 0.5)


@pytest.mark.parametrize("s,hd", [(257, 64), (400, 80), (13, 64)])
def test_qq_p_row_amax_is_one_over_its_row_sum(s, hd):
    """The twin's p = e / sum(e) with e = exp(s - max): the max's e is
    exp(0) = 1, so a row's amax is the quotient 1 / sum, bit for bit (what
    the tiled route quantizes p with, without a max over p)."""
    qkv = torch.from_numpy(_x(2, s, 3 * 2 * hd, seed=s))
    for h in range(2):
        sc = _scores(qkv, 2, h)
        e = torch.exp(sc - sc.amax(-1, keepdim=True))
        p = e / e.sum(-1, keepdim=True)
        assert torch.equal(p.amax(-1, keepdim=True), 1.0 / e.sum(-1, keepdim=True))
    sk = {}
    fbq.attention_qq_core_plain(qkv, 2, torch.bfloat16, scratch=sk)
    assert torch.equal(sk["psc"], torch.clamp(fbq.true_div(sk["p"].amax(-1, keepdim=True),
                                                           127.0), min=1e-8))


def _tiled_core(qkv32, heads, tile=64):
    """csrc/attention_qq.cuh's tiled route in torch: per 64-key tile the
    running max and the rescaled sum, then p = exp(s - m) / l from the final
    max and sum, its codes at the scale of 1 / l, int32 P V over every tile
    and one f32 conversion at the end."""
    d = qkv32.shape[-1] // 3
    hd = d // heads
    outs = []
    for h in range(heads):
        sc = _scores(qkv32, heads, h)
        v = list(fb._head_qkv(qkv32, heads, h))[2]
        m = torch.full(sc.shape[:-1] + (1,), -math.inf)
        l = torch.zeros_like(m)
        for k0 in range(0, sc.shape[-1], tile):
            t = sc[..., k0:k0 + tile]
            n = torch.maximum(m, t.amax(-1, keepdim=True))
            l = l * torch.where(torch.isinf(m), torch.zeros_like(m), torch.exp(m - n)) \
                + torch.exp(t - n).sum(-1, keepdim=True)
            m = n
        ps = torch.clamp(fbq.true_div(1.0 / l, 127.0), min=1e-8)
        vq, vsc = fbq.quant_rows(v.transpose(1, 2))
        acc = torch.zeros(sc.shape[:-1] + (hd,), dtype=torch.int32)
        for k0 in range(0, sc.shape[-1], tile):
            p = torch.exp(sc[..., k0:k0 + tile] - m) / l
            pq = torch.clamp(torch.round(p / ps), -127, 127).to(torch.int8)
            acc = acc + fbq._bmm_exact(pq, vq[..., k0:k0 + tile].transpose(1, 2))
        outs.append((acc.float() * ps * vsc.transpose(1, 2)).to(torch.bfloat16))
    return torch.cat(outs, -1)


@pytest.mark.parametrize("s,hd", [(257, 64), (785, 64), (130, 80), (1100, 64)])
def test_tiled_route_arithmetic_is_the_twin(s, hd):
    """The emulated tiled route against the twin: its sum is the same sum in
    another order (per tile, rescaled), so a p code can differ where p
    lands on a rounding boundary; the output stays within one bf16 ulp of
    the twin's largest magnitude, and nearly every code agrees."""
    qkv = torch.from_numpy(_x(2, s, 3 * 2 * hd, seed=hd))
    got = _tiled_core(qkv, 2)
    want = fbq.attention_qq_core_plain(qkv, 2, torch.bfloat16)
    within_one_ulp(got, want)


# ---------------------------------------------------------------------------
# The s8 wgmma core's order, emulated in numpy (csrc/attention_qq.cuh)
# ---------------------------------------------------------------------------

QQ_TILE, QQ_NO_MAX, QQ_MAX_SEQ = 64, 256, 256
F32 = np.float32


def _np_quant_rows(x):
    """quant_rows in numpy float32: (int8 codes, f32 scales [..., 1])."""
    sc = np.maximum(np.abs(x).max(-1, keepdims=True) / F32(127), F32(1e-8)).astype(F32)
    return np.clip(np.rint(x / sc), -127, 127).astype(np.int8), sc


def _thread_sums(e, l0=None):
    """Each row's e [R, 8 n] summed as the kernel's quad does: thread t (of
    four) adds its columns 8 j + 2 t, 8 j + 2 t + 1 in order of j onto l0
    [R, 4] (zeros by default), one f32 rounding a step; returns [R, 4]."""
    per = e.reshape(e.shape[0], -1, 4, 2).transpose(0, 2, 1, 3).reshape(e.shape[0], 4, -1)
    acc = np.zeros(per.shape[:2], F32) if l0 is None else l0
    for i in range(per.shape[-1]):
        acc = (acc + per[..., i]).astype(F32)
    return acc


def _quad(l):
    """quad_sum over the four threads of a row: (l0 + l1) + (l2 + l3)."""
    return ((l[:, 0] + l[:, 1]).astype(F32) + (l[:, 2] + l[:, 3]).astype(F32)).astype(F32)


def _qq_keys(s):
    return 64 if s <= 64 else 128 if s <= 128 else 224 if s <= 224 else 256


def qq_core_emulated(qkv, heads, out_dtype=torch.bfloat16):
    """The s8 wgmma core's arithmetic in its order, in numpy: qkv f32 [B, S,
    3D] -> (out f32 holding ``out_dtype`` values [B, S, D], p [B, H, S, S],
    pq, psc [B, H, S, 1]).  Register route (head dim up to 64, S <= 256): one pass over
    the key bucket, the row max, e = exp(s - m), the row sum in the quad's
    thread order, p = e / l, p's scale from its row max.  Tiled route: pass
    1 walks 64-key tiles keeping the row max and each thread's rescaled sum
    (l * exp(m - m_new) + its new e's), the quad's sum at the end; pass 2
    p = exp(s - m) / l with p's scale qq_scale(1 / l).  P V: exact integer
    sums of p's codes and v's (per column) codes over every key, by groups
    of at most 256 output columns sharing one m and l, converted to f32
    once: (o * p scale) * v scale, rounded to ``out_dtype`` (the card's
    core: bf16)."""
    b, s, d3 = qkv.shape
    d = d3 // 3
    hd = d // heads
    hdp = -(-hd // 64) * 64
    scale = F32(1.0 / hd ** 0.5)
    register = hdp == 64 and s <= QQ_MAX_SEQ
    n = _qq_keys(s) if register else -(-s // QQ_TILE) * QQ_TILE
    out = np.zeros((b, s, d), F32)
    ps_all, pq_all, psc_all = (np.zeros((b, heads, s, s), F32), np.zeros((b, heads, s, s), np.int8),
                               np.zeros((b, heads, s, 1), F32))
    for bi in range(b):
        for h in range(heads):
            q, k, v = (qkv[bi, :, i * d + h * hd:i * d + (h + 1) * hd] for i in range(3))
            qq, qs = _np_quant_rows(q)
            kq, ks = _np_quant_rows(k)
            vq, vs = _np_quant_rows(np.ascontiguousarray(v.T))  # [hd, S]
            s32 = qq.astype(np.int64) @ kq.astype(np.int64).T
            sc = np.full((s, n), -np.inf, F32)
            sc[:, :s] = ((s32.astype(F32) * qs).astype(F32) * ks.T).astype(F32) * scale
            with np.errstate(invalid="ignore", over="ignore"):
                if register:
                    m = sc.max(-1, keepdims=True)
                    e = np.where(np.isinf(sc), F32(0), np.exp(sc - m)).astype(F32)
                    l = _quad(_thread_sums(e))[:, None]
                    p = (e / l).astype(F32)
                    ps = np.maximum(p.max(-1, keepdims=True) / F32(127), F32(1e-8)).astype(F32)
                else:
                    m = np.full((s, 1), -np.inf, F32)
                    lt = np.zeros((s, 4), F32)
                    for k0 in range(0, n, QQ_TILE):
                        t = sc[:, k0:k0 + QQ_TILE]
                        new = np.maximum(m, t.max(-1, keepdims=True))
                        lt = (lt * np.where(np.isinf(m), F32(0), np.exp(m - new))).astype(F32)
                        lt = _thread_sums(np.where(np.isinf(t), F32(0),
                                                   np.exp(t - new)).astype(F32), lt)
                        m = new
                    l = _quad(lt)[:, None]
                    ps = np.maximum((F32(1) / l) / F32(127), F32(1e-8)).astype(F32)
                    p = np.where(np.isinf(sc), F32(0), np.exp(sc - m) / l).astype(F32)
            pq = np.clip(np.rint(p / ps), -127, 127).astype(np.int8)
            o = np.zeros((s, hd), F32)
            for c0 in range(0, hd, QQ_NO_MAX):  # output groups, one m and l
                acc = pq[:, :s].astype(np.int64) @ vq[c0:c0 + QQ_NO_MAX].astype(np.int64).T
                o[:, c0:c0 + QQ_NO_MAX] = (acc.astype(F32) * ps).astype(F32) * vs[c0:c0 + QQ_NO_MAX].T
            out[bi, :, h * hd:(h + 1) * hd] = _np32(torch.from_numpy(o).to(out_dtype))
            ps_all[bi, h], pq_all[bi, h], psc_all[bi, h] = p[:, :s], pq[:, :s], ps
    return out, ps_all, pq_all, psc_all


QQ_HDS = [64, 80, 128, 256, 800]
QQ_SEQS = [1, 33, 64, 65, 197, 256, 257, 785]


@pytest.mark.parametrize("hd", QQ_HDS)
@pytest.mark.parametrize("s", QQ_SEQS)
def test_emulated_wgmma_core_keeps_the_contract(s, hd):
    """The emulated core against the twin (attention_qq_core_plain), on the
    contract the card's core is held to: p's codes are quant_rows of its own
    p (so p's scale from 1 / l is its row max's), its output is the exact
    P V on its own codes, its p within 1e-6 of the twin's, and every output
    past one bf16 ulp of the twin's sits on a row with a flipped p code."""
    heads = 2
    qkv = _x(1, s, 3 * heads * hd, seed=s * 1000 + hd)
    got, p, pq, psc = qq_core_emulated(qkv, heads)
    sr = {}
    ref = _np32(fbq.attention_qq_core_plain(torch.from_numpy(qkv), heads, torch.bfloat16,
                                            scratch=sr))
    own_q, own_s = fbq.quant_rows(torch.from_numpy(p))
    assert torch.equal(own_q, torch.from_numpy(pq)) and torch.equal(own_s, torch.from_numpy(psc))
    vq, vsc = fbq.quant_rows(torch.from_numpy(qkv[..., 2 * heads * hd:]).reshape(
        1, s, heads, hd).permute(0, 2, 3, 1))
    own = (torch.from_numpy(pq).double() @ vq.transpose(-1, -2).double()).float() \
        * torch.from_numpy(psc) * vsc.transpose(-1, -2)
    own = _np32(own.to(torch.bfloat16).permute(0, 2, 1, 3).reshape(1, s, heads * hd))
    assert np.array_equal(got, own)
    assert np.abs(p - _np32(sr["p"])).max() <= 1e-6
    past = (np.abs(got - ref) > 2.0 ** (math.floor(math.log2(np.abs(ref).max())) - 7))
    flipped = (pq != sr["pq"].numpy()).any(-1).transpose(0, 2, 1)  # [B, S, H]
    assert not (past.reshape(1, s, heads, hd).any(-1) & ~flipped).any()


@pytest.mark.parametrize("hd", QQ_HDS)
@pytest.mark.parametrize("s", QQ_SEQS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_wgmma_block_matches_the_pallas_kernel(int8_cores, monkeypatch, s, hd, dtype):
    """KB (a) 1's block with the emulated core in the twin's place, against
    benchmarks/attn_int8_cores.py::attention_block_qq in interpret mode (one
    head of hd, so D = hd): within one bf16 ulp of the largest magnitude
    (the block's bar on the card), and at float32 also at the full-width bar
    of tests/kb_helpers.py against the twin's block.  (At one head of D =
    hd the twin's own float32 block sits past atol 1e-4 of JAX's on up to
    44% of its rows: XLA's LayerNorm and softmax round their last bits
    otherwise and flip int8 codes.)"""
    import jax.numpy as jnp

    attn, _ = _layer(hd, seed=s + hd)
    x = _t(_x(1, s, hd, seed=s * 7 + hd), getattr(torch, dtype))
    ref = int8_cores.attention_block_qq(_jnp(_np32(x), getattr(jnp, dtype)), *map(_jnp, attn),
                                        heads=1)
    twin = fbq.attention_block_qq_plain(x, *map(_t, attn), heads=1)

    def emulated(qkv, heads, out_dtype, scratch=None, scale=None):
        return torch.from_numpy(qq_core_emulated(_np32(qkv), heads, out_dtype)[0]).to(out_dtype)

    monkeypatch.setattr(fbq, "attention_qq_core_plain", emulated)
    got = fbq.attention_block_qq_plain(x, *map(_t, attn), heads=1)
    assert got.dtype == x.dtype
    within_one_ulp(got, ref)
    if dtype == "float32":
        check(got, twin, dtype, full_width=True)


def _qq_ws_parts(b, s, heads, hdp):
    """csrc/attention_qq.cuh's workspace, part by part (bytes, each rounded
    up to 256): q, k codes [B H, Sp, hdp], v^T codes [B H, hdp, Sp], q, k
    scales [B H, Sp], v scales [B H, hdp], and past 256 output columns each
    row's max and sum [B H, Sp]."""
    bh, sp = b * heads, -(-s // QQ_TILE) * QQ_TILE

    def al(x):
        return -(-x // 256) * 256

    parts = [al(bh * sp * hdp)] * 3 + [al(bh * sp * 4)] * 2 + [al(bh * hdp * 4)]
    return parts + ([al(bh * sp * 4)] * 2 if hdp > QQ_NO_MAX else [])


@pytest.mark.parametrize("b,s,heads,hdp", [(256, 197, 12, 64), (32, 785, 12, 64), (2, 197, 12, 128),
                                            (1, 1, 1, 64), (2, 77, 2, 832)])
def test_qq_workspace_layout(b, s, heads, hdp):
    """Both routes take the workspace: the codes in wgmma's tile layout
    (rows of S rounded up to 64 keys), the scales, and past 256 output
    columns the statistics launch's row max and sum."""
    parts = _qq_ws_parts(b, s, heads, hdp)
    assert all(p % 256 == 0 for p in parts)
    assert len(parts) == (8 if hdp > 256 else 6)
    sp = -(-s // 64) * 64
    assert sum(parts[:3]) >= 3 * b * heads * sp * hdp
    assert sp % 64 == 0 and (sp * hdp) % 16 == 0  # the TMA's 16-byte strides


@pytest.mark.parametrize("q", range(16))
def test_v_codes_are_stored_in_the_fragments_key_order(q):
    """Position 4t + i of a 16-key group of v^T holds key 8 (i / 2) + 2t + i
    % 2: the i-th byte of the A fragment register a thread packs from its
    accumulator columns (2t, 2t + 1, 8 + 2t, 9 + 2t), so P V needs no byte
    shuffle; the map is a permutation."""
    perm = [8 * ((p & 3) >> 1) + 2 * (p >> 2) + (p & 1) for p in range(16)]
    assert sorted(perm) == list(range(16))
    t, i = q >> 2, q & 3
    assert perm[q] == [2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t][i]
    src = (pathlib.Path(fbq.__file__).resolve().parent.parent / "csrc" /
           "attention_qq.cuh").read_text()
    assert "return 8 * ((q & 3) >> 1) + 2 * (q >> 2) + (q & 1);" in src


# ---------------------------------------------------------------------------
# The KB entries off the registry widths
# ---------------------------------------------------------------------------


@pytest.fixture
def attn_variants(monkeypatch):
    mod = _load("attn_variants")
    monkeypatch.setattr(mod.pl, "pallas_call",
                        functools.partial(mod.pl.pallas_call, interpret=True))
    return mod


def _bf16_block(d, seed):
    rng = np.random.default_rng(seed)

    def rn(*shape, std=1.0):
        return (rng.normal(size=shape) * std).astype(np.float32)

    return (1 + rn(d, std=0.1), rn(d, std=0.1), rn(d, 3 * d, std=d ** -0.5),
            rn(3 * d, std=0.1), rn(d, d, std=d ** -0.5), rn(d, std=0.1))


@pytest.mark.parametrize("d,heads", OFF_REGISTRY)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_opt_off_the_registry_widths(attn_variants, d, heads, dtype):
    import jax.numpy as jnp

    ls, lb, wqkv, bqkv, wo, bo = _bf16_block(d, seed=d)
    wq, bq = attn_variants.prescale_qkv(_jnp(wqkv), _jnp(bqkv), d, heads)
    x = _x(2, 77, d, seed=5)
    ref = attn_variants.attention_block_opt(_jnp(x, getattr(jnp, dtype)), _jnp(ls), _jnp(lb),
                                            wq, bq, _jnp(wo), _jnp(bo), heads=heads)
    got = fb.attention_block_opt(_t(x, getattr(torch, dtype)), _t(ls), _t(lb),
                                 _t(np.asarray(wq)), _t(np.asarray(bq)), _t(wo), _t(bo),
                                 heads=heads)
    if dtype == "bfloat16":
        within_one_ulp(got, ref)
    else:
        np.testing.assert_allclose(_np32(got), _np32(ref), atol=1e-4)


@pytest.mark.parametrize("d,heads", OFF_REGISTRY)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hgrid_off_the_registry_widths(attn_variants, d, heads, dtype):
    import jax.numpy as jnp

    ls, lb, wqkv, bqkv, wo, bo = _bf16_block(d, seed=d + 1)
    hd = d // heads
    scale = hd ** -0.5 * math.log2(math.e)
    wq = np.concatenate([wqkv[:, :d] * scale, wqkv[:, d:]], axis=1)
    bq = np.concatenate([bqkv[:d] * scale, bqkv[d:]])
    wqkv_h = np.stack([np.concatenate([wq[:, i * d + h * hd:i * d + (h + 1) * hd]
                                       for i in range(3)], axis=1) for h in range(heads)])
    bqkv_h = np.stack([np.concatenate([bq[i * d + h * hd:i * d + (h + 1) * hd]
                                       for i in range(3)]) for h in range(heads)])
    x = _x(2, 50, d, seed=6)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = attn_variants.attention_block_hgrid(
        jnp.asarray(x, jdt), _jnp(ls), _jnp(lb), jnp.asarray(wqkv_h, jdt), _jnp(bqkv_h),
        jnp.asarray(wo, jdt), _jnp(bo), heads=heads)
    got = fb.attention_block_hgrid(_t(x, tdt), _t(ls), _t(lb), _t(wqkv_h, tdt), _t(bqkv_h),
                                   _t(wo, tdt), _t(bo), heads=heads)
    if dtype == "float32":
        _close_f32(got, ref)
    else:
        within_one_ulp(got, ref)


@pytest.fixture(scope="module")
def mlp_bodies():
    return capture(("q_kernel_variants", "q_mlp_bf16h"),
                   {"VAR_BATCH": 12, "ILP_BATCH": 12, "VAR_STEPS": 1, "ILP_STEPS": 1})


@pytest.mark.parametrize("kind", ["var", "var_bf16_gelu", "bf16h"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_bodies_off_the_registry_widths(mlp_bodies, kind, dtype):
    """KB (a) 2 and 3's MLP bodies at D = 200, F = 800 (the card pads the
    hidden to 896 lanes and D to 256 columns: ``mlp_plan``)."""
    import jax.numpy as jnp

    d = 200
    mlp = _layer(d, seed=9)[1]
    if kind == "bf16h":
        kern = functools.partial(mlp_bodies["pipe_kernel"][0].func, bb=1, depth=2, bf16h=True)
        twin = fbq.mlp_block_q_bf16h
    else:
        gelu = kind == "var_bf16_gelu"
        kern = next(k for k in mlp_bodies["mlp_q_kernel_var"] if k.keywords["bf16_gelu"] == gelu)
        twin = functools.partial(fbq.mlp_block_q_var, bf16_gelu=gelu)
    x = _x(2, 77, d, seed=3)
    ref = _interpret(kern, _jnp(x, getattr(jnp, dtype)), _pallas_ops(mlp))
    got = twin(_t(x, getattr(torch, dtype)), *map(_t, mlp))
    check(got, ref, dtype, full_width=True)
    plan = fb.mlp_plan(d, 4 * d)
    assert (plan.fp, plan.dk, plan.no) == (896, 256, 256) and not plan.identity
