"""The one-call int8 layer (``fused_block_q.fused_layer_q``;
csrc/fused_block_q.cu::dvl_fused_layer_q): LayerNorm and its quantize pass
in one launch at both norms, the QKV product on the persistent TMA-store s8
GEMM (``gemm_s8_tma_kernel``), the down product on the persistent GEMM with
epilogue warpgroups (``gemm_s8_epi_kernel``) where its rows are whole
16-byte units (``layer_route``), the other products on the s8 GEMM.

CPU: the persistent tile walk (``tg_tile`` and ``tg_band``, mirrored here)
covers every output tile exactly once over the blocks of the grid, at
ViT-B/16's M = 50,432, a ragged M and M < 128, for the products' N = 2,304
/ 768 / 3,072 and for bands narrower than N; the bf16 staging's byte
layout (``tg_stage_offset``) is the TMA's 128-byte swizzle of its two
[64][64] boxes, every byte written once and a warp's writes of a column
group one wavefront; the down product's int32 half-tile buffer
(``te_half_offset``): the consumers' writes and the epilogue threads' reads
cover every element once, at the same bytes; the source states what the
mirrors mirror; the route rule's bounds; the SASS checks of chip_smoke.py
on a stand-in dump (each kernel's IGMMA, UTMALDG and UTMASTG; no mma.sync
in the library); the route counter; the
twin against JAX's ``layer_kernel`` (benchmarks/q_layer_fused.py) in
interpret mode.  ``cuda`` (skipped without a card): the layer on both
routes and the twin at D = 768, 1,024, 200 and 203 (the down product's
rows not whole 16-byte units: route "qkv") and a ragged M, every code
the quantization of the kernel's own rows (the LayerNorm rows K3's and
K4's), and the layer bit-equal to the design before it
(``benchmarks_torch/layer_parent.json``).

    python -m pytest tests/test_torch_layer_q.py -q -p no:randomly
"""

import collections
import functools
import importlib.util
import json
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

from debias_vision_lang_torch.ops import fused_block_q as fbq
from kb_helpers import _jnp, _layer, _pallas_ops, _t, _x, capture, check, interpret, within_one_ulp

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CSRC = REPO / "debias_vision_lang_torch" / "csrc"
SBM = SBN = 128  # the output tile
BAND_BYTES = 16 << 20  # TG_BAND_BYTES
SMS = 132  # the H100's SMs: the persistent grid's blocks
TG_BOX = 64 * 128  # a staging box: 64 rows of 128 bytes


def _source():
    return (CSRC / "fused_block_q.cu").read_text()


def _band(nt, k):
    """csrc/fused_block_q.cu::tg_band."""
    return max(1, min(nt, BAND_BYTES // (SBN * k)))


def _tile(tile, mt, nt, band):
    """csrc/fused_block_q.cu::tg_tile: (m0, n0) of tile ``tile``."""
    b = tile // (mt * band)
    first = b * band
    w = min(band, nt - first)
    r = tile - b * mt * band
    return (r // w) * SBM, (first + r % w) * SBN


def test_the_mirrors_state_the_kernels_walk():
    src = _source()
    tile = src[src.index("void tg_tile(int tile"):]
    tile = tile[:tile.index("\n}\n")]
    for line in ("const int b = tile / (mt * band), first = b * band;",
                 "const int w = nt - first < band ? nt - first : band, r = tile - b * mt * band;",
                 "m0 = (r / w) * SBM;", "n0 = (first + r % w) * SBN;"):
        assert line in tile
    assert "constexpr long long TG_BAND_BYTES = 16ll << 20;" in src
    band = src[src.index("int tg_band(int nt, int K) {"):]
    assert "TG_BAND_BYTES / ((long long)SBN * K);" in band[:200]
    kern = src[src.index("gemm_s8_tma_kernel(const __grid_constant__"):
               src.index("int tg_band(int nt, int K)")]
    assert "for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)" in kern
    assert kern.count("tg_tile(tile, mt, nt, band, m0, n0);") == 2  # producer and consumers
    assert "tiles < g_sm_count ? tiles : g_sm_count" in src


@pytest.mark.parametrize("k", [768, 32768])  # 32768: bands of 4 N tiles
@pytest.mark.parametrize("n", [2304, 768, 3072])  # QKV, out / down, up at ViT-B/16
@pytest.mark.parametrize("m", [256 * 197, 8 * 197, 77])
def test_the_persistent_walk_covers_every_tile_once(m, n, k):
    mt, nt = -(-m // SBM), n // SBN
    band = _band(nt, k)
    tiles = mt * nt
    grid = min(tiles, SMS)
    seen = collections.Counter()
    for block in range(grid):
        walk = [_tile(t, mt, nt, band) for t in range(block, tiles, grid)]
        assert len(walk) in (tiles // grid, -(-tiles // grid))  # the blocks' shares
        seen.update(walk)
    assert len(seen) == tiles and set(seen.values()) == {1}
    assert all(0 <= m0 < m and m0 % SBM == 0 and 0 <= n0 < n and n0 % SBN == 0
               for m0, n0 in seen)
    if k == 768:  # the whole weight is one band: the tiles in flight share their A rows
        assert band == nt
        first_round = {_tile(t, mt, nt, band)[0] for t in range(grid)}
        assert len(first_round) <= -(-grid // nt) + 1
    else:  # bands of 4 N tiles (the last one narrower): each band's tiles in a row
        assert band == 4
        order = [_tile(t, mt, nt, band) for t in range(tiles)]
        bands = [n0 // (band * SBN) for _, n0 in order]
        assert bands == sorted(bands)


# ---------------------------------------------------------------------------
# The staging buffer the TMA stores read
# ---------------------------------------------------------------------------


def _stage_offset(r, col):
    """csrc/fused_block_q.cu::tg_stage_offset: the byte of bf16 element (r,
    col) of a warpgroup's staging."""
    return (col >> 6) * TG_BOX + r * 128 + ((((col & 63) >> 3) ^ r) & 7) * 16 + (col & 7) * 2


def _tma_box_offset(r, col):
    """The byte of bf16 element (r, col) of two [64][64] boxes (64 bf16 a
    128-byte row) under the TMA's 128-byte swizzle."""
    box, cc = divmod(col, 64)
    return box * TG_BOX + r * 128 + ((cc // 8) ^ (r % 8)) * 16 + (cc % 8) * 2


def _thread_writes():
    """(warp, lane, j, h) -> (row, col) of a consumer thread's 4-byte write:
    wgmma's accumulator layout, rows 16 warp + lane / 4 (+ 8), columns 8 j +
    2 (lane % 4) and the next."""
    for warp in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for j in range(SBN // 8):
                for h in range(2):
                    yield (warp, lane, j, h), (16 * warp + g + 8 * h, 8 * j + 2 * t)


def test_the_staging_offset_is_the_sources():
    src = _source()
    fn = src[src.index("__device__ __forceinline__ int tg_stage_offset(int r, int col) {"):]
    assert ("return (col >> 6) * TG_BOX + r * 128 + (((((col & 63) >> 3) ^ r) & 7) << 4) + "
            "(col & 7) * 2;") in fn[:300]
    assert "constexpr int TG_BOX = 64 * 128;" in src
    assert "tma_store_2d(&tm_c, stage + TG_BOX, n0 + 64, row0);" in src


def test_the_staging_is_the_tma_swizzle_every_byte_once():
    """Each thread's two bf16 values land where the TMA store of its box
    reads them, and the 64 x 128 tile fills the 16 KB staging exactly."""
    written = collections.Counter()
    for _, (r, col) in _thread_writes():
        at = _stage_offset(r, col)
        assert at % 4 == 0
        for e in range(2):
            assert _stage_offset(r, col + e) == _tma_box_offset(r, col + e) == at + 2 * e
        written.update(range(at, at + 4))
    assert len(written) == 64 * SBN * 2 and set(written.values()) == {1}
    assert max(written) == 2 * TG_BOX - 1


def test_a_warps_staging_writes_are_one_wavefront():
    """The 32 lanes' 4-byte writes of one column group and row half hit the
    32 banks once each (128 bytes, one wavefront)."""
    groups = collections.defaultdict(list)
    for (warp, lane, j, h), (r, col) in _thread_writes():
        groups[(warp, j, h)].append(_stage_offset(r, col) // 4 % 32)
    assert all(sorted(banks) == list(range(32)) for banks in groups.values())


def _half_offset(r, col):
    """csrc/fused_block_q.cu::te_half_offset: the byte of int32 element (r,
    col) of a half-tile buffer ([64][32] boxes under the 128-byte swizzle)."""
    return (col >> 5) * TG_BOX + r * 128 + ((((col & 31) >> 2) ^ r) & 7) * 16 + (col & 3) * 4


def _tma_f32_box_offset(r, col):
    box, cc = divmod(col, 32)
    return box * TG_BOX + r * 128 + ((cc // 4) ^ (r % 8)) * 16 + (cc % 4) * 4


def test_the_half_buffer_offset_is_the_sources():
    src = _source()
    fn = src[src.index("__device__ __forceinline__ int te_half_offset(int r, int col) {"):]
    assert ("return (col >> 5) * TG_BOX + r * 128 + (((((col & 31) >> 2) ^ r) & 7) << 4) + "
            "(col & 3) * 4;") in fn[:300]
    kern = src[src.index("gemm_s8_epi_kernel(const __grid_constant__"):
               src.index("bool layer_down_fits(int D)")]
    assert "const int e = wg - 2, cg = tid & 15, rr = tid >> 4;" in kern
    assert "half + te_half_offset(warp * 16 + g + 8 * h, 8 * j + 2 * t)" in kern
    assert "half + te_half_offset(r, 8 * cg)" in kern and "te_half_offset(r, 8 * cg + 4)" in kern
    assert "stage + tg_stage_offset(r, 8 * cg)" in kern


def test_the_half_buffer_is_written_and_read_once_each_element():
    """The consumers' int2 writes (wgmma's accumulator layout) and the
    epilogue threads' two 16-byte reads of 8 columns of 8 rows cover the 64
    x 128 int32 half exactly once each, at the same bytes, in the f32 TMA box
    layout; the epilogue's bf16 rows land in the staging once each."""
    written, read, staged = collections.Counter(), collections.Counter(), collections.Counter()
    for _, (r, col) in _thread_writes():
        at = _half_offset(r, col)
        assert at == _tma_f32_box_offset(r, col) and _half_offset(r, col + 1) == at + 4
        written.update(range(at, at + 8))
    for tid in range(128):
        cg, rr = tid & 15, tid >> 4
        for k in range(8):
            r = rr + 8 * k
            for c0 in (8 * cg, 8 * cg + 4):
                at = _half_offset(r, c0)
                assert at % 16 == 0 and [_half_offset(r, c0 + i) for i in range(4)] == [
                    at, at + 4, at + 8, at + 12]
                read.update(range(at, at + 16))
            at = _stage_offset(r, 8 * cg)
            assert at % 16 == 0 and _stage_offset(r, 8 * cg + 7) == at + 14
            staged.update(range(at, at + 16))
    assert written == read and len(written) == 64 * SBN * 4 and set(written.values()) == {1}
    assert len(staged) == 64 * SBN * 2 and set(staged.values()) == {1}


def _down_fits(d):
    """csrc/fused_block_q.cu::layer_down_fits."""
    return d >= 8 and d % 8 == 0


def test_the_route_rule_is_the_sources():
    src = _source()
    assert "bool layer_down_fits(int D) { return D >= 8 && D % 8 == 0; }" in src
    assert "int dvl_layer_down_fits(int D) { return layer_down_fits(D); }" in src
    entry = src[src.index("int dvl_fused_layer_q("):]
    assert "tma && layer_down_fits(D)" in entry[:entry.index("\n}\n")]


@pytest.mark.parametrize("d,want", [(768, "tma"), (1024, "tma"), (512, "tma"), (200, "tma"),
                                    (8, "tma"), (203, "qkv"), (204, "qkv"), (4, "qkv"),
                                    (1, "qkv"), (1280, "tma")])
def test_the_route_rule_bounds(d, want):
    """The down product's bf16 output and f32 y rows of d values are whole
    16-byte units (the TMA stores, the epilogue's 8-column reads) exactly
    where d % 8 == 0."""
    assert ("tma" if _down_fits(d) else "qkv") == want
    assert _down_fits(d) == (d * 2 % 16 == 0 and d * 4 % 16 == 0)


# ---------------------------------------------------------------------------
# chip_smoke.py's SASS checks, on a stand-in dump
# ---------------------------------------------------------------------------


def _smoke():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


TMA = "_ZN12_GLOBAL__N_118gemm_s8_tma_kernelE14CUtensorMap_stS0_S0_PKfS2_S2_iiii"
EPI = "_ZN12_GLOBAL__N_118gemm_s8_epi_kernelE14CUtensorMap_stS0_S0_PKfS2_S2_S2_iiiii"


def _library_dump(tma_body):
    """A stand-in cuobjdump -sass of the int8 library: the instantiations the
    per-kernel checks count, each with its design's instructions, the
    library-wide ones, and the persistent GEMM with ``tma_body``."""
    funcs = {f"_ZN12_GLOBAL__N_119attention_qq_kernelILi{n}EEEv14CUtensorMap_st": "IGMMA.64x64x32"
             ".S32.S8.S8 ; UTMALDG.3D ;" for n in (64, 128, 224, 256)}
    funcs.update({f"_ZN12_GLOBAL__N_125attention_qq_tiled_kernelILi{n}EEEv14CUtensorMap_st":
                  "IGMMA.64x64x32.S32.S8.S8 ; UTMALDG.3D ;" for n in (64, 128, 192, 256)})
    funcs.update({f"_ZN12_GLOBAL__N_119rows_strip_q_kernelI{t}Li{kb}EEEvPKT_6TpPtrsi":
                  "IGMMA.64x128x32.S32.S8.S8 ; UTMALDG.2D ; UTMASTG.2D ;"
                  for t in ("13__nv_bfloat16", "f") for kb in (1, 2, 3)})
    funcs["_ZN12_GLOBAL__N_122attention_wgmma_kernelILi200ELi0ELi1ELi1EEEv14CUtensorMap_st"] = (
        "HGMMA.64x200x16.F32.BF16 ;")
    funcs[TMA] = tma_body
    funcs[EPI] = "IGMMA.64x128x32.S32.S8.S8 ; UTMALDG.2D ; UTMASTG.2D ;"
    return "".join(f"\n\tFunction : {name}\n{body}\n" for name, body in funcs.items())


@pytest.mark.parametrize("broken", [None, "no UTMASTG", "no IGMMA", "no UTMALDG", "missing",
                                    "IMMA", "HMMA"])
def test_the_sass_check_holds_the_persistent_gemm(monkeypatch, broken):
    """The library's SASS check (chip_smoke.sass_check): gemm_s8_tma_kernel
    and gemm_s8_epi_kernel, one instantiation each, hold s8 wgmma, TMA loads
    and TMA stores (the persistent QKV GEMM's forms broken here); the
    library holds no mma.sync (IMMA. / HMMA.) anywhere."""
    C = _smoke()
    body = {None: "IGMMA.64x128x32.S32.S8.S8 ; UTMALDG.2D ; UTMASTG.2D ;",
            "no UTMASTG": "IGMMA.64x128x32.S32.S8.S8 ; UTMALDG.2D ;",
            "no IGMMA": "UTMALDG.2D ; UTMASTG.2D ;",
            "no UTMALDG": "IGMMA.64x128x32.S32.S8.S8 ; UTMASTG.2D ;",
            "missing": None,
            "IMMA": "IGMMA.64x128x32.S32.S8.S8 ; UTMALDG.2D ; UTMASTG.2D ; IMMA.16832.S8.S8 ;",
            "HMMA": "IGMMA.64x128x32.S32.S8.S8 ; UTMALDG.2D ; UTMASTG.2D ; HMMA.16816.F32 ;",
            }[broken]
    dump = _library_dump(body or "")
    if body is None:
        dump = dump.replace(f"\tFunction : {TMA}\n", "\tFunction : _ZN12_GLOBAL__N_1other\n")
    monkeypatch.setattr(C, "find_cuobjdump", lambda: "cuobjdump")
    monkeypatch.setattr(C.subprocess, "run",
                        lambda *a, **k: types.SimpleNamespace(stdout=dump, returncode=0))
    assert C.SASS_PER_KERNEL_STORE["fused_block_q"] == (
        ("gemm_s8_tma_kernel", ("IGMMA", "UTMALDG", "UTMASTG"), 1),
        ("gemm_s8_epi_kernel", ("IGMMA", "UTMALDG", "UTMASTG"), 1))
    if broken is None:
        C.sass_check("fused_block_q", "lib.so")
    else:
        with pytest.raises(RuntimeError):
            C.sass_check("fused_block_q", "lib.so")


# ---------------------------------------------------------------------------
# Routes, counters, the twin
# ---------------------------------------------------------------------------


def test_routes_are_counted_and_reset():
    assert set(fbq.LAYER_ROUTES) == {"tma", "qkv", "gemm"}
    fbq.LAYER_ROUTES["tma"] += 1
    fbq.reset_launches()
    assert not any(fbq.LAYER_ROUTES.values())


def test_cpu_calls_take_the_twin_and_count_no_route():
    attn, mlp = [_t(a) for a in _layer(64, seed=3)[0]], [_t(a) for a in _layer(64, seed=3)[1]]
    x = _t(_x(2, 9, 64, seed=4), torch.bfloat16)
    fbq.reset_launches()
    sk = {}
    got = fbq.fused_layer_q(x, *attn, *mlp, heads=1, scratch=sk)
    assert torch.equal(got, fbq.fused_layer_q_plain(x, *attn, *mlp, heads=1))
    assert not any(fbq.LAYER_ROUTES.values()) and not fbq.KB_LAUNCHES["fused_layer_q"]
    assert {"xn", "yn", "y", "xq", "yq", "hq"} <= set(sk)  # the twin keeps its rows


def test_the_layer_entry_runs_nine_launches():
    """dvl_fused_layer_q: LayerNorm and quantize in one pass at both norms
    (no LayerNorm rows written), the QKV product on the persistent GEMM or
    the s8 GEMM, the core, the attention rows' quantize pass, the out and up
    products, the hidden's quantize pass, the down product on the
    epilogue-warpgroup GEMM or the s8 GEMM."""
    src = _source()
    entry = src[src.index("int dvl_fused_layer_q("):]
    entry = entry[:entry.index("\n}\n")]
    launches = ["launch_ln_quant(", "launch_gemm_s8_tma(", "launch_attention_wgmma(",
                "launch_quant_rows(", "launch_gemm_s8<EQ_BIAS_RESID_Y>(", "launch_ln_quant(",
                "launch_gemm_s8<EQ_BIAS_QGELU>(", "launch_quant_rows(", "launch_gemm_s8_epi(",
                "launch_gemm_s8<EQ_RESID32_BIAS>("]
    at = 0
    for call in launches:
        at = entry.index(call, at) + 1
    assert "launch_ln(" not in entry and entry.count("launch_gemm_s8<EQ_BIAS>(") == 1
    assert "void* xn" not in entry and "m_xn" not in entry


DTYPES = ["float32", "bfloat16"]


@pytest.fixture(scope="module")
def captured():
    return capture(("q_layer_fused",), {"ILP_BATCH": 4, "ILP_STEPS": 1})


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["seq", "xpipe"])
def test_twin_matches_layer_kernel_on_another_block(captured, mode, dtype):
    """``fused_layer_q`` (its twin on the CPU) against the captured
    ``layer_kernel`` in interpret mode at ViT-B/16's width, on another block
    and input than tests/test_torch_kb_split.py's, under the KB tests'
    full-width bars (tests/kb_helpers.py)."""
    import jax.numpy as jnp

    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    d, heads = 768, 12
    block = _layer(d, seed=28)
    kern = functools.partial(captured["layer_kernel"][0].func, bb=2, mode=mode)
    ls1, lb1, wq, wqs, bq, wo, wos, bo = block[0]
    ops = tuple(map(_jnp, (ls1[None], lb1[None], wq, wqs.reshape(1, -1), bq[None], wo,
                           wos.reshape(1, -1), bo[None]))) + _pallas_ops(block[1])
    x = _x(2, 197, d, seed=29)
    ref = interpret(kern, _jnp(x, jdt), ops, bb=2)
    got = fbq.fused_layer_q(_t(x, tdt), *map(_t, [*block[0], *block[1]]), heads=heads)
    check(got, ref, dtype, full_width=True)


# ---------------------------------------------------------------------------
# CUDA (skipped without a card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled with nvcc for sm_90a "
                    "and have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ops(attn, mlp):
    """``_fused_layer_q_cuda``'s halves from fused_layer_q's arguments (on
    the card, with the transposed weight copies)."""
    (l1s, l1b, wq, wqs, bq, wo, wos, bo), (l2s, l2b, w1, s1, b1, w2, s2, b2) = attn, mlp
    t = lambda w: w.t().contiguous()  # noqa: E731
    return ((l1s, l1b, wqs, bq, wos, bo, t(wq), t(wo)), (l2s, l2b, s1, b1, s2, b2, t(w1), t(w2)))


@pytest.mark.cuda
@pytest.mark.parametrize("d,heads,b,s", [(768, 12, 4, 197), (768, 12, 3, 50), (1024, 16, 2, 77),
                                         (200, 2, 3, 77), (203, 7, 2, 77)])
def test_cuda_both_routes_bit_equal_and_the_twins_bars(cuda, d, heads, b, s):
    attn, mlp = ([_t(a).to(cuda) for a in half] for half in _layer(d, seed=d + s))
    a_ops, m_ops = _ops(attn, mlp)
    kw = {"wqkv_qt": a_ops[6], "wo_qt": a_ops[7], "w1_qt": m_ops[6], "w2_qt": m_ops[7]}
    x = torch.from_numpy(_x(b, s, d, seed=s)).to(cuda, torch.bfloat16)
    fbq.reset_launches()
    sk, so = {}, {}
    got = fbq.fused_layer_q(x, *attn, *mlp, heads=heads, **kw, scratch=sk)
    other = fbq._fused_layer_q_cuda(x, a_ops, m_ops, heads, so, tma=False)
    torch.cuda.synchronize()
    route = "tma" if _down_fits(d) else "qkv"
    assert fbq.layer_route(d) == route
    assert fbq.LAYER_ROUTES == {"tma": 0, "qkv": 0, "gemm": 1, route: 1}
    assert fbq.KB_LAUNCHES["fused_layer_q"] == 2
    assert torch.equal(got, other) and set(sk) == set(so)
    assert all(torch.equal(sk[k], so[k]) for k in sk)
    assert "xn" not in sk and "yn" not in sk  # one pass at both norms: no LayerNorm rows
    # the codes are the quantization of the kernel's own rows: K3's and K4's
    # LayerNorm rows of the same inputs (the same kernel's rows bit for bit)
    s3, s4 = {}, {}
    fbq.attention_block_q(x, *attn, heads=heads, wqkv_qt=kw["wqkv_qt"], wo_qt=kw["wo_qt"],
                          scratch=s3)
    assert torch.equal(sk["yb"], sk["y"].to(torch.bfloat16))
    fbq.mlp_block_q(sk["yb"], *mlp, w1_qt=kw["w1_qt"], w2_qt=kw["w2_qt"], scratch=s4)
    for codes, rows, scales in (("xq", s3["xn"], "xs"), ("aq", sk["attn"], "as"),
                                ("yq", s4["xn"], "ys"), ("hq", sk["h"], "hs")):
        q, sc = fbq.quant_rows(rows)
        assert torch.equal(q, sk[codes]) and torch.equal(sc, sk[scales]), codes
    # the reference steps on the CPU (exact int32 products at any N; cuBLAS's
    # int8 GEMM on the card refuses an N that is not a multiple of 8, as 203)
    sk, attn, mlp = ({k: v.cpu() for k, v in sk.items()}, [a.cpu() for a in attn],
                     [a.cpu() for a in mlp])
    x = x.cpu()
    y = x.float() + (fbq.dot_q(sk["aq"], sk["as"], attn[5], attn[6]) + attn[7])
    assert torch.equal(sk["y"], y)
    own = (sk["y"] + mlp[7]) + fbq.dot_q(sk["hq"], sk["hs"], mlp[5], mlp[6])
    within_one_ulp(got.cpu(), own.to(torch.bfloat16))
    sr = {}
    ref = fbq.fused_layer_q_plain(x, *attn, *mlp, heads=heads, scratch=sr)
    if all(torch.equal(sk[k], sr[k]) for k in ("xq", "aq", "yq", "hq")):
        within_one_ulp(got.cpu(), ref)


@pytest.mark.cuda
def test_cuda_layer_bit_equal_to_the_parent_design(cuda):
    """Every output, code and scale of benchmarks_torch/layer_split.py's
    cases and its 12-layer tower bit-equal to layer_parent.json, the design
    before the redesign."""
    spec = importlib.util.spec_from_file_location(
        "layer_split", REPO / "benchmarks_torch" / "layer_split.py")
    L = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(L)
    parent = json.loads((REPO / "benchmarks_torch" / "layer_parent.json").read_text())
    assert L.output_digests(fbq, cuda) == parent["outputs"]
