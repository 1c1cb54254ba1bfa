"""The bf16 tensor-parallel slot entries' routes (``ops/fused_block.py::
attention_block_heads`` / ``mlp_block_cols``; csrc/fused_block.cu).

A slot whose product K is narrow -- a head group's g hdp attention columns,
or its Fp hidden columns, at most 384 -- and whose f32 rows are whole
16-byte units (D % 4 == 0) writes its partial from the
row-strip kernel (``gemm_strip_f32_kernel``: a 128-row strip of the
product's input kept in shared memory, every N tile of the weight walked on
it, each tile leaving by TMA stores while the next one's products run):
"strip".  Other
slots keep K1 / K2's GEMM with the f32 epilogue: "gemm".  Both routes take
the same wgmma products in the same K order, so they agree bit for bit.

CPU: the twins the routes share (the partials summed over the slots are
the unsharded block's function) and the row-strip kernel's f32 staging
(every value where the TMA stores of its swizzled boxes read it, two
wavefronts a warp write).  ``cuda`` (skipped without a card; the rule is
the library's, csrc/fused_block.cu::strip_fits, which ``slot_route`` asks):
the route of every split the towers make (``slot_route`` on ``group_plan``
/ ``mlp_plan``: ViT-B/16's and the text tower's m = 2 and 8, head dims 80,
D = 200, and 203 whose f32 rows are no whole 16-byte units for the TMA
stores), each route's partial against the other bit for bit and the twin
within 1 bf16 ulp, at registry and off-registry widths, causal, on the long
core, both activations, counted per route.
"""

import math

import numpy as np
import pytest
import torch

from debias_vision_lang_torch.ops import fused_block as fb
from debias_vision_lang_torch.parallel import tensor as tpar

torch.set_num_threads(1)


# (D, heads, F, m) -> ({g: route}, mlp route)
SPLITS = [
    ((768, 12, 3072, 2), {6: "strip"}, "gemm"),       # ViT-B/16 over 2: g hdp = 384, Fj 1,536
    ((768, 12, 3072, 8), {2: "strip", 1: "strip"}, "strip"),  # over 8: 128 / 64, Fj 384
    ((512, 8, 2048, 2), {4: "strip"}, "gemm"),        # the text tower: 256, Fj 1,024
    ((512, 8, 2048, 8), {1: "strip"}, "strip"),       # Fj 256
    ((768, 12, 3072, 4), {3: "strip"}, "gemm"),       # Fj 768
    ((1280, 16, 5120, 4), {4: "gemm"}, "gemm"),       # head dim 80 (hdp 128): 512
    ((1280, 16, 5120, 8), {2: "strip"}, "gemm"),      # 256; Fj 640
    ((200, 2, 800, 2), {1: "strip"}, "gemm"),         # hd 100 -> hdp 128; Fj 400 -> 512
    ((200, 2, 800, 4), {1: "strip", 0: None}, "strip"),  # Fj 200 -> 256
    ((203, 7, 812, 7), {1: "gemm"}, "gemm"),          # D % 4 != 0: no whole 16-byte f32 rows
    ((1024, 16, 4096, 16), {1: "strip"}, "strip"),    # ViT-L's width over 16: Fj 256
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,att,mlp", SPLITS)
def test_slot_route_of_each_split(cuda, shape, att, mlp):
    d, heads, f, m = shape
    got = {}
    for j in range(m):
        lo, hi = tpar.head_group(heads, m, j)
        if hi > lo:
            got[hi - lo] = fb.slot_route(fb.group_plan(d, d // heads, hi - lo).da, d)
    assert got == {g: r for g, r in att.items() if r is not None}
    assert fb.slot_route(fb.mlp_plan(d, f // m).fp, d) == mlp


@pytest.mark.cuda
@pytest.mark.parametrize("k,d,want", [
    (64, 768, "strip"), (384, 768, "strip"), (448, 768, "gemm"), (1536, 768, "gemm"),
    (64, 204, "strip"), (64, 203, "gemm"), (128, 4, "strip"), (0, 768, "gemm"),
    (96, 768, "gemm")])
def test_slot_route_bounds(cuda, k, d, want):
    assert fb.slot_route(k, d) == want


def test_routes_are_counted_and_reset():
    assert set(fb.SLOT_ROUTES) == {"attention_strip", "attention_gemm", "mlp_strip", "mlp_gemm"}
    fb.SLOT_ROUTES["mlp_strip"] += 1
    fb.reset_launches()
    assert not any(fb.SLOT_ROUTES.values())


def test_cpu_calls_take_the_twin_whatever_the_route():
    """On the CPU the entries are their twins and count no route (the route
    is the card's)."""
    rng = np.random.default_rng(0)
    d, g, hd, fj = 64, 2, 16, 96
    x = torch.from_numpy(rng.normal(size=(2, 5, d)).astype(np.float32)).to(torch.bfloat16)
    ln = (torch.ones(d), torch.zeros(d))
    wqkv = torch.from_numpy(rng.normal(size=(d, 3 * g * hd)).astype(np.float32)) * 0.1
    bqkv = torch.zeros(3 * g * hd)
    wo = torch.from_numpy(rng.normal(size=(g * hd, d)).astype(np.float32)) * 0.1
    w1 = torch.from_numpy(rng.normal(size=(d, fj)).astype(np.float32)) * 0.1
    w2 = torch.from_numpy(rng.normal(size=(fj, d)).astype(np.float32)) * 0.1
    fb.reset_launches()
    assert torch.equal(fb.attention_block_heads(x, *ln, wqkv, bqkv, wo, heads=g),
                       fb.attention_block_heads_plain(x, *ln, wqkv, bqkv, wo, heads=g))
    assert torch.equal(fb.mlp_block_cols(x, *ln, w1, torch.zeros(fj), w2),
                       fb.mlp_block_cols_plain(x, *ln, w1, torch.zeros(fj), w2))
    assert not any(fb.SLOT_ROUTES.values())


def _staging_offset(r: int, j: int, t: int) -> int:
    """csrc/fused_block.cu::gemm_strip_f32_kernel: the byte of the staging
    half where thread (row r, quad lane t) puts column group j's float2."""
    cc = (j & 3) * 8 + 2 * t
    return ((j >> 2) & 1) * (64 * 128) + r * 128 + ((((cc >> 2) ^ r) & 7) << 4) + (cc & 3) * 4


def _tma_f32_box_offset(r: int, col: int) -> int:
    """The byte of f32 element (r, col) of two [64][32] boxes under the
    TMA's 128-byte swizzle: 16-byte chunk col % 32 // 4 of row r lands at
    chunk ^ (r % 8)."""
    b, cc = divmod(col, 32)
    return b * (64 * 128) + r * 128 + (((cc // 4) ^ (r % 8)) * 16) + (cc % 4) * 4


@pytest.mark.parametrize("hf", [0, 1])
def test_strip_staging_is_the_tma_swizzle(hf):
    """Each half tile (64 rows, column groups 8 hf .. 8 hf + 7) lands where
    the TMA stores of its two [64][32] boxes read it, every byte once."""
    seen = set()
    for r in range(64):
        for j in range(8 * hf, 8 * hf + 8):
            for t in range(4):
                off = _staging_offset(r, j, t)
                col = (j * 8 + 2 * t) - 64 * hf
                assert off == _tma_f32_box_offset(r, col)
                assert off % 8 == 0
                seen.update((off, off + 4))
    assert len(seen) == 64 * 64 and max(seen) < 64 * 64 * 4


def test_strip_staging_writes_two_wavefronts():
    """A warp's float2 writes of one column group (rows 16 w + g, g < 8,
    lanes t) touch every bank exactly twice: 256 bytes in two wavefronts."""
    for w in range(4):
        for h in range(2):
            for j in range(16):
                banks = [(_staging_offset(16 * w + lane // 4 + 8 * h, j, lane % 4) // 4 + e) % 32
                         for lane in range(32) for e in range(2)]
                assert sorted(banks) == sorted(list(range(32)) * 2)


@pytest.mark.parametrize("m", [2, 8])
def test_slot_partials_sum_to_the_unsharded_twins(m):
    """The slots' twins (both routes compute them) reduced over a split are
    K1 + K2's twins within 1 bf16 ulp."""
    rng = np.random.default_rng(m)
    d, heads, b, s = 128, 4, 2, 9
    f = 4 * d

    def rn(*shape, std=1.0):
        return torch.from_numpy((rng.normal(size=shape) * std).astype(np.float32))

    x = rn(b, s, d).to(torch.bfloat16)
    ln = (1 + rn(d, std=0.1), rn(d, std=0.1))
    wqkv, bqkv, wo, bo = rn(d, 3 * d, std=d ** -0.5), rn(3 * d, std=0.1), rn(d, d, std=d ** -0.5), \
        rn(d, std=0.1)
    w1, b1, w2, b2 = rn(d, f, std=(2 * d) ** -0.5), rn(f, std=0.1), rn(f, d, std=f ** -0.5), \
        rn(d, std=0.1)
    hd = d // heads
    parts, mparts = [], []
    for j in range(m):
        lo, hi = tpar.head_group(heads, m, j)
        hid = slice(j * f // m, (j + 1) * f // m)
        mparts.append(fb.mlp_block_cols(x, *ln, w1[:, hid], b1[hid], w2[hid]))
        if hi == lo:
            continue
        cols = tpar.head_columns(d, m, j, heads)
        parts.append(fb.attention_block_heads(x, *ln, wqkv[:, cols], bqkv[cols],
                                              wo[lo * hd:hi * hd], heads=hi - lo))
    for got, want in ((fb.tp_reduce(parts, bo, x, bias_first=False),
                       fb.attention_block(x, *ln, wqkv, bqkv, wo, bo, heads=heads)),
                      (fb.tp_reduce(mparts, b2, x, bias_first=True),
                       fb.mlp_block(x, *ln, w1, b1, w2, b2))):
        ulp = 2.0 ** (math.floor(math.log2(want.float().abs().max().item())) - 7)
        assert (got.float() - want.float()).abs().max().item() <= ulp


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


def _card_params(d, f, dev, seed):
    rng = np.random.default_rng(seed)

    def rn(*shape, std=1.0):
        return torch.from_numpy((rng.normal(size=shape) * std).astype(np.float32)).to(dev)

    return {"ln": (1 + rn(d, std=0.1), rn(d, std=0.1)), "wqkv": rn(d, 3 * d, std=d ** -0.5),
            "bqkv": rn(3 * d, std=0.1), "wo": rn(d, d, std=d ** -0.5),
            "w1": rn(d, f, std=(2 * d) ** -0.5), "b1": rn(f, std=0.1), "w2": rn(f, d, std=f ** -0.5)}


def _one_ulp(got, ref, what):
    err = (got.float() - ref.float()).abs().max().item()
    tol = 2.0 ** (math.floor(math.log2(ref.float().abs().max().item())) - 7)
    assert err <= tol, f"{what}: {err} > 1 bf16 ulp {tol}"


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,heads,m,causal", [
    (4, 197, 768, 12, 8, False), (4, 197, 768, 12, 2, False), (5, 77, 512, 8, 8, True),
    (5, 77, 512, 8, 2, True), (2, 400, 768, 12, 2, False), (3, 77, 200, 2, 2, False),
    (3, 33, 203, 7, 7, False), (2, 65, 1280, 16, 8, False), (2, 65, 1280, 16, 4, False),
    (3, 50, 768, 12, 4, False), (2, 50, 200, 2, 2, True)])
def test_cuda_attention_strip_is_the_gemm_route(cuda, b, s, d, heads, m, causal):
    """Every head group's partial on its route (the out product on the
    row-strip kernel up to g hdp = 384) equals the GEMM route's bit for bit
    and the twin within 1 bf16 ulp; each call counted on its route."""
    t = _card_params(d, 4 * d, cuda, seed=d + m)
    x = torch.from_numpy(np.random.default_rng(b + s).normal(size=(b, s, d))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    hd = d // heads
    for j in range(m):
        lo, hi = tpar.head_group(heads, m, j)
        if hi == lo:
            continue
        cols = tpar.head_columns(d, m, j, heads).to(cuda)
        ga = (*t["ln"], t["wqkv"][:, cols], t["bqkv"][cols], t["wo"][lo * hd:hi * hd])
        fb.reset_launches()
        got = fb.attention_block_heads(x, *ga, heads=hi - lo, causal=causal)
        route = fb.slot_route(fb.group_plan(d, hd, hi - lo).da, d)
        assert fb.SLOT_ROUTES[f"attention_{route}"] == 1
        other = fb._heads_cuda(x, *ga, hi - lo, causal, strip=False)
        assert torch.equal(got, other), f"slot {j}: the {route} partial is not the GEMM's"
        _one_ulp(got, fb.attention_block_heads_plain(x, *ga, heads=hi - lo, causal=causal),
                 f"slot {j}")


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,m,act", [
    (4, 197, 768, 8, "quick_gelu"), (4, 197, 768, 8, "gelu"), (5, 77, 512, 8, "quick_gelu"),
    (3, 77, 200, 4, "quick_gelu"), (3, 33, 203, 7, "gelu"), (2, 50, 768, 24, "quick_gelu"),
    (2, 65, 1024, 16, "gelu"), (1, 1, 768, 8, "quick_gelu"), (4, 197, 768, 2, "quick_gelu"),
    (3, 77, 200, 2, "gelu")])
def test_cuda_mlp_strip_is_the_gemm_route(cuda, b, s, d, m, act):
    """The MLP slot on its route (the down product on the row-strip kernel
    at Fp = 128, 256 and 384, on the GEMM past it) equals the GEMM route's
    bit for bit and the twin within 1 bf16 ulp, at ragged D and a single row
    (D = 203 takes the GEMM)."""
    f = 4 * d
    t = _card_params(d, f, cuda, seed=d * m)
    x = torch.from_numpy(np.random.default_rng(s).normal(size=(b, s, d))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    for j in (0, m - 1):
        hid = slice(j * f // m, (j + 1) * f // m)
        gm = (*t["ln"], t["w1"][:, hid], t["b1"][hid], t["w2"][hid])
        route = fb.slot_route(fb.mlp_plan(d, f // m).fp, d)
        fb.reset_launches()
        got = fb.mlp_block_cols(x, *gm, act_kind=act)
        assert fb.SLOT_ROUTES[f"mlp_{route}"] == 1
        other = fb._mlp_cols_cuda(x, *gm, act, strip=False)
        assert fb.SLOT_ROUTES["mlp_gemm"] == 1 + (route == "gemm")
        assert torch.equal(got, other), f"slot {j}: the {route} partial is not the GEMM's"
        _one_ulp(got, fb.mlp_block_cols_plain(x, *gm, act_kind=act), f"slot {j}")
