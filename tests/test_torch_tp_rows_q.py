"""The int8 tensor-parallel row-parallel product, ``rows_q_partial``
(``ops/fused_block_q.py``; csrc/fused_block_q.cu::dvl_rows_q_partial).

A slot's input (its head group's attention rows, bf16, or its hidden
columns, f32) is quantized at the row scale of the max of every slot's row
amax -- the scale JAX's ``_quant_rows`` gives the whole row -- and
multiplied by the slot's rows of the weight into a raw int32 partial; the
partials summed over the slots are the unsharded ``_dot_q``'s int32
accumulator.  On the card it takes one of two routes (``rows_route``, the
library's rule ``rows_strip_fits``): where K is a multiple of 64 up to 384
and the int32 rows are whole 16-byte units, one launch of the row-strip
kernel (``rows_strip_q_kernel``: each 128-row strip quantized into shared
memory in the layout the s8 wgmma reads, every N tile of the weight walked
on it, each int32 tile stored by TMA through a swizzled staging): "strip";
else the warp-a-row quantize pass and the s8 GEMM: "gemm".

CPU: the twin against JAX (``_quant_rows`` of the whole row, then
``dot_general`` in int32 on the slot's K rows) over K, the input's dtype
and the number of slots, at a ragged M and on an all-zero row, exact .5
ties and a NaN row; the kernels' quotient (the corrected reciprocal product
where the row scale is finite) against IEEE division in exact arithmetic; a
numpy emulation of the strip kernel's shared memory
(the codes where the swizzled descriptor reads them, the int32 staging
where the TMA stores read it, two wavefronts a warp write); the route
counter.  ``cuda`` (skipped without a card): both routes and the twin bit
for bit at K = 48-1,536, m = 1-256, a ragged M, the padded plans and a NaN
row, each call counted on its route, and the rule's bounds.
"""

import numpy as np
import pytest
import torch

from debias_vision_lang_torch.ops import fused_block as fb
from debias_vision_lang_torch.ops import fused_block_q as fbq

torch.set_num_threads(1)

N_OUT = 40  # the weight's output columns in the CPU cases


def _jax_reference(whole, w):
    """JAX's codes and scales of the whole rows and the int32 accumulator of
    the unsharded product."""
    import jax
    import jax.numpy as jnp

    from debias_vision_lang_tpu.ops.fused_block_q import _quant_rows

    q, s = _quant_rows(jnp.asarray(whole))
    acc = jax.lax.dot_general(q, jnp.asarray(w), (((q.ndim - 1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    return np.asarray(q), np.asarray(s), np.asarray(acc)


def _slots(whole, w, k, m, dtype):
    """Each slot's twin: (int32 partial, codes, row scales) of its K columns
    at the max of the m slots' row amaxes."""
    x = torch.from_numpy(whole).to(dtype)
    cols = [slice(j * k, (j + 1) * k) for j in range(m)]
    amaxes = [fbq.row_amax(x[..., c]) for c in cols]
    wq = torch.from_numpy(w)
    return [fbq.rows_q_partial_plain(x[..., c].contiguous(), amaxes, wq[c]) for c in cols]


def _check_against_jax(whole, w, k, m, dtype):
    # the JAX function sees the slot inputs' own values (bf16 rows widened)
    seen = torch.from_numpy(whole).to(dtype).float().numpy()
    jq, js, jacc = _jax_reference(seen, w)
    outs = _slots(whole, w, k, m, dtype)
    total = np.zeros_like(jacc)
    for j, (acc, aq, ascale) in enumerate(outs):
        np.testing.assert_array_equal(aq.numpy(), jq[..., j * k:(j + 1) * k])
        np.testing.assert_array_equal(ascale.numpy(), js)  # NaN where JAX's is
        total += acc.numpy()
    np.testing.assert_array_equal(total, jacc)
    return outs, js


@pytest.mark.parametrize("m", [1, 2, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [64, 128, 256, 384, 1536])
def test_twin_is_jaxs_quant_rows_and_int32_dot(k, dtype, m):
    """Each slot's codes are JAX's on its columns, its row scales JAX's of
    the whole row, and the partials sum to JAX's int32 accumulator."""
    rng = np.random.default_rng(k + m)
    whole = (rng.normal(size=(2, 7, m * k)) * rng.uniform(0.1, 4.0, size=(2, 7, 1))).astype(
        np.float32)
    w = rng.integers(-127, 128, size=(m * k, N_OUT)).astype(np.int8)
    _check_against_jax(whole, w, k, m, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["ragged", "zero", "ties", "nan"])
def test_twin_is_jaxs_on_special_rows(kind, dtype):
    """A ragged M (3 x 197 rows over 8 slots of K = 384), an all-zero row
    (scale 1e-8, codes 0), exact .5 ties (round half to even) and a NaN row
    (NaN scale, codes 0, a zero partial) as JAX gives them."""
    rng = np.random.default_rng(["ragged", "zero", "ties", "nan"].index(kind))
    b, s, k, m = (3, 197, 384, 8) if kind == "ragged" else (2, 5, 64, 2)
    whole = rng.normal(size=(b, s, m * k)).astype(np.float32)
    if kind == "zero":
        whole[1, 2] = 0.0
    elif kind == "ties":
        # amax 127 makes the scale exactly 1: every half is a tie
        row = rng.integers(-126, 126, size=m * k).astype(np.float32) + 0.5
        row[3] = 127.0
        whole[0, 1] = row
        whole[1, 3, :9] = [0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 126.5, -126.5, 127.0]
    elif kind == "nan":
        whole[1, 4, k + 3] = np.nan  # in slot 1's columns: every slot's row goes NaN
    w = rng.integers(-127, 128, size=(m * k, N_OUT)).astype(np.int8)
    outs, js = _check_against_jax(whole, w, k, m, dtype)
    if kind == "zero":
        assert js[1, 2, 0] == np.float32(1e-8)
        assert all(not aq[1, 2].any() for _, aq, _ in outs)
    elif kind == "ties":
        aq, ascale = outs[0][1], outs[0][2]
        assert ascale[0, 1, 0].item() == 1.0 and ascale[1, 3, 0].item() == 1.0
        assert aq[1, 3, :9].tolist() == [0, 0, 2, -2, 2, -2, 126, -126, 127]
        np.testing.assert_array_equal(aq[0, 1].numpy(), np.rint(whole[0, 1, :k]))
    elif kind == "nan":
        assert np.isnan(js[1, 4, 0])
        for acc, aq, ascale in outs:
            assert not aq[1, 4].any() and torch.isnan(ascale[1, 4]).all()
            assert not acc[1, 4].any()


# ---------------------------------------------------------------------------
# The kernels' quotient: qq_div (csrc/attention_qq.cuh) where the row scale is
# finite, emulated in exact arithmetic
# ---------------------------------------------------------------------------


def _f32(x):
    """``x`` (a Fraction) rounded to float32, half to even (normal range)."""
    from fractions import Fraction

    if x == 0:
        return Fraction(0)
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length() - 24
    while x / Fraction(2) ** e >= 2 ** 24:
        e += 1
    while x / Fraction(2) ** e < 2 ** 23:
        e -= 1
    m = x / Fraction(2) ** e
    n = m.numerator // m.denominator
    rest = m - n
    if rest > Fraction(1, 2) or (rest == Fraction(1, 2) and n % 2):
        n += 1
    return sign * n * Fraction(2) ** e


def _q_code_fast(v, s, rs):
    """csrc/fused_block_q.cu::q_code<true>: qq_div's quotient (a product and
    two FMA corrections, each rounded once), clamped to +-127, rounded half
    to even by the 1.5 2^23 add."""
    q0 = _f32(v * rs)
    q1 = _f32(_f32(-q0 * s + v) * rs + q0)
    y = _f32(_f32(-q1 * s + v) * rs + q1)
    c = min(max(y, -127), 127)
    return int(_f32(c + 12582912) - 12582912)


@pytest.mark.parametrize("amax", [127.0, 63.5, 3.0, 0.013])
def test_fast_quotient_gives_the_ieee_division_s_codes(amax):
    """The strip kernel and the warp-a-row pass code a row with a finite
    scale from qq_div's quotient, not ``__fdiv_rn``: the same IEEE quotient
    (so the same codes as ``quant_rows`` and JAX's ``_quant_rows``), exact .5
    ties included (a scale of 1 or 1/2)."""
    from fractions import Fraction

    rng = np.random.default_rng(int(amax * 1000))
    s = np.maximum(np.float32(amax) / np.float32(127.0), np.float32(1e-8))
    vals = np.concatenate([rng.uniform(-amax, amax, 600), rng.normal(0, amax / 9, 300),
                           (rng.integers(-126, 126, 100) + 0.5) * s,
                           [0.0, -0.0, amax, -amax, 1e-30, -3e-38]]).astype(np.float32)
    fs = Fraction(float(s))
    rs = _f32(1 / fs)  # __frcp_rn
    want = np.clip(np.rint(vals / s), -127, 127).astype(np.int64)  # IEEE division
    got = [_q_code_fast(Fraction(float(v)), fs, rs) for v in vals]
    np.testing.assert_array_equal(np.array(got), want)


# ---------------------------------------------------------------------------
# The row-strip kernel's shared memory, emulated
# ---------------------------------------------------------------------------

SBK, S_TILE = 128, 128 * 128  # a K step of codes, a [128][128] tile


def _strip_code_offset(r: int, k0: int) -> int:
    """csrc/fused_block_q.cu::rows_strip_q_kernel: the byte of a quantizer's
    half of a strip buffer where its row r's code k0 goes (K step k0 / 128,
    its 16-byte chunk at chunk ^ (r % 8) of the row's 128 B)."""
    return (k0 >> 7) * S_TILE + r * 128 + (((((k0 & 127) >> 4) ^ r) & 7) << 4) + (k0 & 15)


def _strip_pad_offsets(q: int, kb: int):
    """Quantizer warpgroup q's zeroing, once, of the last K step past K (K %
    128 == 64) in both strip buffers: chunks 4-7 of each of its 64 rows."""
    for i in range(2 * 64 * 4):
        b, r, ch = i // 256, 64 * q + (i // 4) % 64, 4 + i % 4
        base = b * kb * S_TILE + (kb - 1) * S_TILE + r * 128 + ((ch ^ (r & 7)) << 4)
        yield from range(base, base + 16)


def _wgmma_a_offset(c: int, row: int, k: int) -> int:
    """The byte the s8 wgmma m64n128k32 of warpgroup c reads for its A
    element (row, k): the descriptor's start, desc_sw128(strip + kt S_TILE +
    c 64 128) advanced 32 B a k32 step, 8-row groups 1024 B apart and rows
    of 128 B, then the 128-byte swizzle (address bits 4-6 XOR bits 7-9)."""
    kt, kk, kin = k // SBK, (k % SBK) // 32, k % 32
    lin = kt * S_TILE + c * 64 * 128 + 32 * kk + (row // 8) * 1024 + (row % 8) * 128 + kin
    return lin ^ (((lin >> 7) & 7) << 4)


@pytest.mark.parametrize("vec", [8, 4])  # codes a thread writes: 16 bytes of bf16, of f32
@pytest.mark.parametrize("k", [64, 128, 192, 256, 320, 384])
def test_strip_codes_are_where_the_descriptor_reads(k, vec):
    """Every code of a 128-row strip, written by each quantizer warpgroup's
    flattened 16-byte chunks (64 rows each) into either strip buffer, lands
    where the matching consumer warpgroup's s8 wgmma reads it through its
    swizzled descriptor; the last
    K step's lanes past K read zero; every byte of both buffers is written
    exactly once."""
    kb = -(-k // SBK)
    rng = np.random.default_rng(k + vec)
    codes = rng.integers(1, 255, size=(2, 128, k)).astype(np.uint8)
    strip = np.full(2 * kb * S_TILE, 0xAA, np.uint8)
    writes = np.zeros(2 * kb * S_TILE, np.int32)
    cpr = k // vec
    for q in range(2):  # quantizer warpgroup q: rows 64 q .. 64 q + 63
        if k % SBK:
            for off in _strip_pad_offsets(q, kb):
                strip[off] = 0
                writes[off] += 1
        for b in range(2):
            for i in range(64 * cpr):
                r, k0 = i // cpr, (i % cpr) * vec
                at = b * kb * S_TILE + q * 64 * 128 + _strip_code_offset(r, k0)
                strip[at:at + vec] = codes[b, 64 * q + r, k0:k0 + vec]
                writes[at:at + vec] += 1
    assert (writes == 1).all()
    for b in range(2):
        for c in range(2):
            for row in range(64):
                got = [strip[b * kb * S_TILE + _wgmma_a_offset(c, row, kk)]
                       for kk in range(kb * SBK)]
                assert got == list(codes[b, 64 * c + row]) + [0] * (kb * SBK - k)


def _staging_offset(r: int, j: int, t: int) -> int:
    """rows_strip_q_kernel: the byte of the int32 staging half where thread
    (row r, quad lane t) puts column group j's int2."""
    cc = (j & 3) * 8 + 2 * t
    return ((j >> 2) & 1) * (64 * 128) + r * 128 + ((((cc >> 2) ^ r) & 7) << 4) + (cc & 3) * 4


def _tma_i32_box_offset(r: int, col: int) -> int:
    """The byte of int32 element (r, col) of two [64][32] boxes under the
    TMA's 128-byte swizzle."""
    b, cc = divmod(col, 32)
    return b * (64 * 128) + r * 128 + (((cc // 4) ^ (r % 8)) * 16) + (cc % 4) * 4


@pytest.mark.parametrize("hf", [0, 1])
def test_strip_int32_staging_is_the_tma_swizzle(hf):
    """Each half tile (64 rows, column groups 8 hf .. 8 hf + 7) of the s32
    accumulators lands where the TMA stores of its two [64][32] int32 boxes
    read it, every byte once."""
    seen = set()
    for r in range(64):
        for j in range(8 * hf, 8 * hf + 8):
            for t in range(4):
                off = _staging_offset(r, j, t)
                assert off == _tma_i32_box_offset(r, j * 8 + 2 * t - 64 * hf)
                seen.update((off, off + 4))
    assert len(seen) == 64 * 64 and max(seen) < 64 * 64 * 4


def test_strip_int32_staging_writes_two_wavefronts():
    """A warp's int2 writes of one column group touch every bank exactly
    twice: 256 bytes in two wavefronts."""
    for w in range(4):
        for h in range(2):
            for j in range(16):
                banks = [(_staging_offset(16 * w + lane // 4 + 8 * h, j, lane % 4) // 4 + e) % 32
                         for lane in range(32) for e in range(2)]
                assert sorted(banks) == sorted(list(range(32)) * 2)


@pytest.mark.parametrize("broken", [None, "no IGMMA", "no UTMALDG", "missing"])
def test_sass_check_holds_every_rows_strip_instantiation(monkeypatch, broken):
    """chip_smoke.sass_check_per_kernel: each of the row-strip kernel's six
    instantiations (bf16 and f32 inputs, one to three K steps) must hold s8
    wgmma (IGMMA) and TMA loads (UTMALDG); a missing one or form fails."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke as C

    qq = [f"_ZN12_GLOBAL__N_119attention_qq_kernelILi{n}EEEv14CUtensorMap_st"
          for n in (64, 128, 224, 256)]
    qq += [f"_ZN12_GLOBAL__N_125attention_qq_tiled_kernelILi{n}EEEv14CUtensorMap_st"
           for n in (64, 128, 192, 256)]
    funcs = {n: "IGMMA.64x64x32.S32.S8.S8 ; UTMALDG.3D ;" for n in qq}
    strip = [f"_ZN12_GLOBAL__N_119rows_strip_q_kernelI{t}Li{kb}EEEvPKT_6TpPtrsi"
             for t in ("13__nv_bfloat16", "f") for kb in (1, 2, 3)]
    funcs.update({n: "IGMMA.64x128x32.S32.S8.S8 ; UTMALDG.2D ; UTMASTG.2D ;" for n in strip})
    funcs["_ZN12_GLOBAL__N_128quant_rows_given_amax_kernelIfEEvPKT_6TpPtrsiPaPfii"] = "LDG.E.128 ;"
    if broken == "no IGMMA":
        funcs[strip[4]] = "UTMALDG.2D ;"
    elif broken == "no UTMALDG":
        funcs[strip[0]] = "IGMMA.64x128x32.S32.S8.S8 ;"
    elif broken == "missing":
        del funcs[strip[5]]
    monkeypatch.setattr(C, "sass_functions", lambda path: dict(funcs))
    assert C.SASS_PER_KERNEL["fused_block_q"][1] == ("rows_strip_q_kernel", ("IGMMA", "UTMALDG"), 6)
    if broken is None:
        C.sass_check_per_kernel("fused_block_q", "lib.so")
    else:
        with pytest.raises(RuntimeError):
            C.sass_check_per_kernel("fused_block_q", "lib.so")


def test_routes_are_counted_and_reset():
    assert set(fbq.ROWS_ROUTES) == {"strip", "gemm"} and set(fbq.ROWS_INPUTS) == {"bf16", "f32"}
    fbq.ROWS_ROUTES["strip"] += 1
    fbq.ROWS_INPUTS["f32"] += 1
    fbq.reset_launches()
    assert not any(fbq.ROWS_ROUTES.values()) and not any(fbq.ROWS_INPUTS.values())


def test_cpu_calls_take_the_twin_and_count_no_route():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(2, 5, 128)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-127, 128, size=(128, 24)).astype(np.int8))
    amaxes = [fbq.row_amax(a), fbq.row_amax(a) * 2]
    fbq.reset_launches()
    got = fbq.rows_q_partial(a, amaxes, wq)
    assert all(map(torch.equal, got, fbq.rows_q_partial_plain(a, amaxes, wq)))
    assert not any(fbq.ROWS_ROUTES.values()) and not any(fbq.ROWS_INPUTS.values())
    assert not fbq.TP_LAUNCHES["rows_q_partial"]


# ---------------------------------------------------------------------------
# CUDA (skipped without a card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled with nvcc for sm_90a "
                    "and have no CPU mode")
    return torch.device("cuda")


def _bits_equal(x, y):
    """Equal bit for bit, NaNs at the same places counting as equal."""
    if x.dtype == torch.float32:
        return torch.equal(x.isnan(), y.isnan()) and torch.equal(
            x.nan_to_num(0.0), y.nan_to_num(0.0))
    return torch.equal(x, y)


def _card_rows(b, s, k, m, n, dtype, dev, seed, nan_row=None):
    """Slot 0's input [b, s, k] and m amaxes (its own and m - 1 others,
    some rows larger, some smaller), its weight rows [k, n] and transpose."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy((rng.normal(size=(b, s, k)) * 2).astype(np.float32)).to(dev, dtype)
    if nan_row is not None:
        a[nan_row + (3,)] = float("nan")
    own = fbq.row_amax(a)
    amaxes = [own] + [own * torch.from_numpy(rng.uniform(0.5, 1.5, size=(b, s, 1))
                                             .astype(np.float32)).to(dev) for _ in range(m - 1)]
    wq = torch.from_numpy(rng.integers(-127, 128, size=(k, n)).astype(np.int8)).to(dev)
    return a, amaxes, wq, wq.t().contiguous()


def _both_routes(a, amaxes, wq, wqt, plan=None):
    """(route, the call on it, the same on the GEMM route), each counted."""
    fbq.reset_launches()
    got = fbq.rows_q_partial(a, amaxes, wq, w_qt=wqt, plan=plan)
    route = "strip" if fbq.ROWS_ROUTES["strip"] else "gemm"
    assert fbq.ROWS_ROUTES[route] == 1 and fbq.TP_LAUNCHES["rows_q_partial"] == 1
    assert sum(fbq.ROWS_ROUTES.values()) == 1
    assert fbq.ROWS_INPUTS == {"bf16": int(a.dtype == torch.bfloat16),
                               "f32": int(a.dtype == torch.float32)}
    other = fbq._rows_q_partial_cuda(a, amaxes, wqt, plan, strip=False)
    assert fbq.ROWS_ROUTES["gemm"] == 1 + (route == "gemm")
    return route, got, other


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 8, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [48, 64, 128, 320, 384, 400, 1536])
def test_cuda_routes_and_twin_bit_equal(cuda, k, dtype, m):
    """rows_q_partial on its route, on the GEMM route and the twin agree bit
    for bit (codes, row scales, int32 partial) at a ragged M (3 x 197
    rows) and N = 768, each call counted on the route the rule names."""
    a, amaxes, wq, wqt = _card_rows(3, 197, k, m, 768, dtype, cuda, seed=k + m)
    route, got, other = _both_routes(a, amaxes, wq, wqt)
    assert route == fbq.rows_route(k if k % 16 == 0 else k + 16 - k % 16, 768)
    assert route == ("strip" if k % 64 == 0 and k <= 384 else "gemm")
    twin = fbq.rows_q_partial_plain(a, amaxes, wq)
    for x, y, z in zip(got, other, twin):
        assert _bits_equal(x, y) and _bits_equal(x, z)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,d,hd,g,f", [
    ("attn", 1280, 80, 2, None),   # 16 heads of 80 over 8: hdp 128, K = 256
    ("attn", 1280, 80, 4, None),   # over 4: K = 512 (the GEMM)
    ("attn", 200, 100, 1, None),   # D = 200: hdp 128, the int32 rows' ragged N edge
    ("mlp", 200, None, None, 200),  # Fj 200 -> Fp 256
    ("mlp", 1280, None, None, 640),  # Fj 640 (the GEMM)
    ("mlp", 768, None, None, 384)])
def test_cuda_padded_plans(cuda, kind, d, hd, g, f):
    """A slot's rows in its plan's padded layout (zero lanes) on both routes
    equal each other and the twin of the unpadded rows bit for bit."""
    plan = fb.group_plan(d, hd, g) if kind == "attn" else fb.mlp_plan(d, f)
    lanes = plan.head_lanes() if kind == "attn" else plan.hidden_columns()
    width = plan.da if kind == "attn" else plan.fp
    k = lanes.numel()
    for dtype in (torch.bfloat16, torch.float32):
        a, amaxes, wq, wqt = _card_rows(2, 77, k, 2, d, dtype, cuda, seed=d + k)
        a_p = torch.zeros(2, 77, width, dtype=dtype, device=cuda)
        a_p[..., lanes.to(cuda)] = a
        route, got, other = _both_routes(a_p, amaxes, wq, wqt, plan=plan)
        assert route == fbq.rows_route(width, d)
        acc, aq, ascale = fbq.rows_q_partial_plain(a, amaxes, wq)
        for x in (got, other):
            assert torch.equal(x[0], acc) and torch.equal(x[2], ascale)
            assert torch.equal(x[1][..., lanes.to(cuda)], aq) and int(x[1].abs().sum()) == int(
                aq.abs().sum())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [128, 384, 1536])
def test_cuda_nan_row(cuda, k, dtype):
    """A NaN in a row: NaN amax and scale, codes 0, a zero partial on both
    routes, as the twin; the other rows as without it."""
    clean = _card_rows(2, 50, k, 2, 768, dtype, cuda, seed=k)
    a, amaxes, wq, wqt = _card_rows(2, 50, k, 2, 768, dtype, cuda, seed=k, nan_row=(1, 9))
    _, got, other = _both_routes(a, amaxes, wq, wqt)
    twin = fbq.rows_q_partial_plain(a, amaxes, wq)
    ref = fbq.rows_q_partial(*clean[:3], w_qt=clean[3])
    ok = torch.ones(2, 50, dtype=torch.bool, device=cuda)
    ok[1, 9] = False
    for x in (got, other):
        acc, aq, ascale = x
        assert torch.isnan(ascale[1, 9]).all() and not aq[1, 9].any() and not acc[1, 9].any()
        assert all(_bits_equal(y, z) for y, z in zip(x, twin))
        assert all(torch.equal(y[ok], z[ok]) for y, z in zip(x, ref))


# (D, heads, F, m) -> (the attention slots' routes by group size, the MLP slots')
SPLITS = [
    ((768, 12, 3072, 2), {6: "strip"}, "gemm"),     # ViT-B/16 over 2: K = 384; Fj 1,536
    ((768, 12, 3072, 8), {2: "strip", 1: "strip"}, "strip"),  # over 8: 128 / 64; Fj 384
    ((512, 8, 2048, 2), {4: "strip"}, "gemm"),      # the text tower: 256; Fj 1,024
    ((512, 8, 2048, 8), {1: "strip"}, "strip"),     # 64; Fj 256
    ((768, 12, 3072, 4), {3: "strip"}, "gemm"),     # 192; Fj 768
    ((1280, 16, 5120, 4), {4: "gemm"}, "gemm"),     # head dim 80 (hdp 128): 512; Fj 1,280
    ((203, 7, 812, 7), {1: "gemm"}, "gemm"),        # D % 4 != 0: no whole 16-byte int32 rows
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,att,mlp", SPLITS)
def test_cuda_route_of_each_split(cuda, shape, att, mlp):
    from debias_vision_lang_torch.parallel import tensor as tpar

    d, heads, f, m = shape
    got = {}
    for j in range(m):
        lo, hi = tpar.head_group(heads, m, j)
        if hi > lo:
            got[hi - lo] = fbq.rows_route(fb.group_plan(d, d // heads, hi - lo).da, d)
    assert got == att
    assert fbq.rows_route(fb.mlp_plan(d, f // m).fp, d) == mlp


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,want", [
    (64, 768, "strip"), (320, 768, "strip"), (384, 768, "strip"), (448, 768, "gemm"),
    (1536, 768, "gemm"), (48, 768, "gemm"), (400, 768, "gemm"), (96, 768, "gemm"),
    (64, 200, "strip"), (64, 202, "gemm"), (128, 4, "strip"), (0, 768, "gemm")])
def test_cuda_rows_route_bounds(cuda, k, n, want):
    assert fbq.rows_route(k, n) == want
