"""K4's F-split (``fused_block_q.mlp_block_q(fb=)``, KB (a) 7) and KB (a)
2's bf16-hidden MLP (``mlp_block_q_bf16h``) on their Hopper routes
(csrc/fused_block_q.cu): both open with LayerNorm and the quantize pass of
x in one launch (``ln_quant_rows_kernel``); the F-split quantizes hidden
chunks past 1,024 columns with 16-byte loads (``quant_rows_x4_kernel``) and
runs its chunked down product on the epilogue-warpgroup GEMM
(``gemm_s8_epi_chunk_kernel``: the consumers hand each chunk's int32 tile to
two epilogue warpgroups, which keep the f32 sum of the chunks) where
``fsplit_route`` takes it; KB (a) 2's up product runs on the persistent
TMA-store GEMM (``gemm_s8_tma_kernel``) and its gelu-and-quantize pass
loads 8 bf16 at a time (``qgelu_quant_rows_kernel``).  Four launches a
call each.

CPU: the route rule and the quantize passes' tiers against the source
text; a mirror of the epilogue warpgroups' chunk fold (the int32 product of
each padded chunk, (acc * chunk scale) * channel scale summed from 0 in
chunk order, the residual and bias last) equal to ``mlp_block_q_plain(fb=)``
bit for bit at fb = 1,536, 768, 1,024, 192 and 1,076; a mirror of the
consumers' and epilogue warpgroups' hand-offs over k chunks a tile under
every interleaving a random scheduler finds (each barrier phase awaited
once, never aliased; each int32 element written and read once a hand-off;
each ring stage handed back once); the persistent walk at the F-split's
shapes; the quantize passes' units covering every row once; the twins
against JAX's ``mlp_block_q(fb=)``, ``make_fsplit(k)``'s body and
``pipe_kernel`` (bf16h) in interpret mode at widths the other files do not
take; the counters; chip_smoke.py's SASS check of the new GEMM on a
stand-in dump.  ``cuda`` (skipped without a card): both routes bit-equal at
D = 768, 1,152, 200 and 203, the codes the quantization of the kernel's own
rows, and every digest of ``benchmarks_torch/mlp_q_split.py`` equal to
``benchmarks_torch/mlp_q_parent.json`` (the design before this one).

    python -m pytest tests/test_torch_mlp_q_split.py -q -p no:randomly
"""

import collections
import functools
import importlib.util
import json
import pathlib
import random
import sys
import types

import numpy as np
import pytest
import torch

from debias_vision_lang_torch.ops import fused_block as fb
from debias_vision_lang_torch.ops import fused_block_q as fbq
from debias_vision_lang_torch.ops import quant
from kb_helpers import _jnp, _layer, _pallas_ops, _t, _x, capture, check, interpret

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CSRC = REPO / "debias_vision_lang_torch" / "csrc"
SBM = SBN = SBK = 128  # the s8 GEMM's tile and K step
QR_THREADS = 128  # a quantize pass's block
BAND_BYTES = 16 << 20  # TG_BAND_BYTES
SMS = 132
TG_BOX = 64 * 128


def _source():
    return (CSRC / "fused_block_q.cu").read_text()


def _between(src, start, end):
    return src[src.index(start):src.index(end, src.index(start))]


def _mlp(d, f, seed):
    """An int8 MLP half at D = d, F = f: numpy tensors in ``mlp_block_q``'s
    argument order (the weights quantized by the port's quantize_weight)."""
    rng = np.random.default_rng(seed)

    def rn(*shape, std=1.0):
        return (rng.normal(size=shape) * std).astype(np.float32)

    def qz(w):
        qw = quant.quantize_weight(torch.from_numpy(w))
        return qw["q"].numpy(), qw["scale"].numpy()

    return (1 + rn(d, std=0.1), rn(d, std=0.1), *qz(rn(d, f, std=(2 * d) ** -0.5)),
            rn(f, std=0.1), *qz(rn(f, d, std=f ** -0.5)), rn(d, std=0.1))


# ---------------------------------------------------------------------------
# The route rule and the quantize passes' tiers
# ---------------------------------------------------------------------------


MIN_STEPS = 8  # FSPLIT_MIN_STEPS: the chunk's K steps the epilogue-warpgroup GEMM wants


def _fsplit_fits(d, chunk):
    """csrc/fused_block_q.cu::fsplit_down_fits (layer_down_fits(D), whole K
    steps a chunk and at least FSPLIT_MIN_STEPS of them)."""
    return d >= 8 and d % 8 == 0 and chunk % SBK == 0 and chunk >= MIN_STEPS * SBK


def _route(d, fbv):
    """ops/fused_block_q.py::fsplit_route's answer from the rule."""
    return "epi" if _fsplit_fits(d, fb.round_up(fbv, fbq.S8_GEMM_TILE)) else "gemm"


def test_the_route_rule_is_the_sources():
    src = _source()
    rule = src[src.index("bool fsplit_down_fits(int D, int chunk) {"):]
    assert ("return layer_down_fits(D) && chunk % SBK == 0 && chunk >= FSPLIT_MIN_STEPS * SBK;"
            in rule[:rule.index("\n}\n")])
    assert "constexpr int FSPLIT_MIN_STEPS = 8;" in src
    assert "bool layer_down_fits(int D) { return D >= 8 && D % 8 == 0; }" in src
    assert ("int dvl_fsplit_down_fits(int D, int chunk) { return fsplit_down_fits(D, chunk); }"
            in src)
    impl = _between(src, "int mlp_block_q_impl(", "}  // namespace")
    assert "else if (k > 1 && tma && fsplit_down_fits(D, F / k))" in impl
    launch = _between(src, "cudaError_t launch_gemm_s8_epi_chunk(", "\n}\n")
    assert "!fsplit_down_fits(ldc, chunk)" in launch
    py = pathlib.Path(fbq.__file__).read_text()
    body = _between(py, "def fsplit_route(", "def _mlp_block_q_cuda(")
    assert "_lib().dvl_fsplit_down_fits(d, round_up(fb, S8_GEMM_TILE))" in body


@pytest.mark.parametrize("d,fbv,want", [
    (768, 1536, "epi"), (768, 1024, "epi"), (1152, 1076, "epi"), (1024, 2048, "epi"),
    (8, 1024, "epi"), (200, 1000, "epi"), (768, 897, "epi"), (768, 768, "gemm"),
    (768, 192, "gemm"), (200, 400, "gemm"), (768, 896, "gemm"), (203, 1024, "gemm"),
    (204, 1632, "gemm"), (4, 1024, "gemm"), (770, 1540, "gemm")])
def test_the_route_rule_bounds(d, fbv, want):
    """The down product's bf16 output and residual rows of d values are whole
    16-byte units exactly where d % 8 == 0; every fb's padded chunk is whole K
    steps (``mlp_plan`` rounds it up to 128), the epilogue-warpgroup GEMM's
    when they are 8 or more (fb past 896: 1,024 columns padded)."""
    assert _route(d, fbv) == want
    plan = fb.mlp_plan(d, 4 * fbv, fbv)
    assert plan.fbp % SBK == 0 and plan.fp == plan.k * plan.fbp
    assert _fsplit_fits(d, plan.fbp) == (d * 2 % 16 == 0 and d >= 8 and plan.fbp >= 1024)


def _chunk_pass(n):
    """csrc/fused_block_q.cu::launch_quant_chunks: the F-split's pass over
    chunks of n (padded) columns: ("x4", units a thread) past 1,024 columns,
    else quant_rows_kernel's tier ("rows", values a thread), K4's."""
    if n <= 8 * QR_THREADS or n > 16 * QR_THREADS or n % 4:
        return ("rows", 8 if n <= 8 * QR_THREADS else 32 if n <= 32 * QR_THREADS else "wide")
    return ("x4", 3 if n <= 12 * QR_THREADS else 4)


def _qgelu_pass(n):
    """csrc/fused_block_q.cu::launch_qgelu_quant: KB (a) 2's pass over rows of
    n bf16: ("x8", 16-byte units a thread), past 5,120 values or off whole
    units quant_rows_kernel's QGELU tiers ("rows", ...)."""
    units = n // 8
    if n % 8 or units > 5 * QR_THREADS:
        return ("rows", 32 if n <= 32 * QR_THREADS else "wide")
    return ("x8", -(-units // QR_THREADS))


def test_the_quantize_tiers_are_the_sources():
    src = _source()
    chunks = _between(src, "cudaError_t launch_quant_chunks(", "\n}\n")
    for line in ("if (n <= 8 * QR_THREADS || n > 16 * QR_THREADS || n % 4)",
                 "return launch_quant_rows(h, q, scale, rows, n, st);",
                 "if (n <= 12 * QR_THREADS)",
                 "quant_rows_x4_kernel<3><<<rows, QR_THREADS, 0, st>>>(h, q, scale, n);",
                 "quant_rows_x4_kernel<4><<<rows, QR_THREADS, 0, st>>>(h, q, scale, n);"):
        assert line in chunks
    qgelu = _between(src, "cudaError_t launch_qgelu_quant(", "\n}\n")
    assert "if (n % 8 || units > 5 * QR_THREADS)" in qgelu
    assert "return launch_quant_rows_mode<false, true>(u, q, scale, g, rows, n, st);" in qgelu
    for pv in range(1, 6):
        assert f"qgelu_quant_rows_kernel<{pv}><<<rows, QR_THREADS, 0, st>>>" in qgelu
    impl = _between(src, "int mlp_block_q_impl(", "}  // namespace")
    # K4 (k = 1) keeps its tiers; the chunks and bf16h take the new passes
    assert ("e = launch_quant_rows(static_cast<const float*>(h), static_cast<int8_t*>(hq),\n"
            "                          static_cast<float*>(hs), M, F, st);") in impl
    assert "launch_quant_chunks(static_cast<const float*>(h)" in impl and "M * k, F / k" in impl
    assert "launch_qgelu_quant(static_cast<const bf16*>(h)" in impl
    # both passes code with q_code (the IEEE quotient: qq_div where the row
    # scale is finite, __fdiv_rn where not), one branch a row
    x4 = _between(src, "quant_rows_x4_kernel(const float*", "\n}\n")
    assert "q_chunk_as<float, true>(v[j], s, rs)" in x4
    assert "q_chunk_as<float, false>(v[j], s, rs)" in x4 and "if (s < INFINITY) {" in x4
    codes = _between(src, "__device__ __forceinline__ void qgelu_codes(", "\n}\n")
    assert "q_code<FAST>(v[j][c], s, rs)" in codes
    qg = _between(src, "qgelu_quant_rows_kernel(const bf16*", "\n}\n")
    assert "quick_gelu(f.x)" in qg and "qgelu_codes<PV, true>" in qg
    assert "qgelu_codes<PV, false>" in qg


@pytest.mark.parametrize("n,want", [
    (1536, ("x4", 3)), (1152, ("x4", 3)), (1280, ("x4", 3)), (2048, ("x4", 4)),
    (1664, ("x4", 4)), (1024, ("rows", 8)), (768, ("rows", 8)), (256, ("rows", 8)),
    (512, ("rows", 8)), (3072, ("rows", 32)), (4096, ("rows", 32))])
def test_the_chunk_pass_tier(n, want):
    """Chunks past 1,024 columns take the 16-byte pass (fb = 1,536 at
    ViT-B/16: 3 units of 4 a thread, none idle; SigLIP's 1,076 padded to
    1,152: 2.25); up to 1,024 quant_rows_kernel's 8-slot tier, as K4's
    rows of that width."""
    assert _chunk_pass(n) == want


@pytest.mark.parametrize("n,want", [(3072, ("x8", 3)), (896, ("x8", 1)), (1024, ("x8", 1)),
                                    (4352, ("x8", 5)), (5120, ("x8", 5)), (4096, ("x8", 4)),
                                    (2048, ("x8", 2)), (8192, ("rows", "wide")),
                                    (5248, ("rows", "wide"))])
def test_the_qgelu_pass_tier(n, want):
    """ViT-B/16's F = 3,072: 3 units of 8 bf16 a thread (24 values, none
    idle); D = 200's 896 padded columns 1; SigLIP's 4,352 and ViT-H's 5,120
    5; bigG's 8,192 the two-read pass."""
    assert _qgelu_pass(n) == want


@pytest.mark.parametrize("n,unit", [(1536, 4), (1152, 4), (2048, 4), (3072, 8), (896, 8),
                                    (4352, 8), (5120, 8)])
def test_a_passes_units_cover_the_row_once(n, unit):
    """Thread t of a row's block loads units t, t + 128, ... of 16 bytes
    (consecutive lanes consecutive units: a warp's loads coalesce); with
    PV units a thread every unit of the row is loaded and coded once, the
    codes at the unit's own offset (``unit`` values a unit)."""
    units = n // unit
    pv = -(-units // QR_THREADS)
    seen = collections.Counter()
    for t in range(QR_THREADS):
        for j in range(pv):
            i = t + j * QR_THREADS
            if i < units:
                seen[i] += 1
    assert sorted(seen) == list(range(units)) and set(seen.values()) == {1}
    for j in range(pv):  # a warp's 32 lanes read 512 consecutive bytes
        lanes = [t + j * QR_THREADS for t in range(32) if t + j * QR_THREADS < units]
        assert lanes == list(range(lanes[0], lanes[0] + len(lanes))) if lanes else True


# ---------------------------------------------------------------------------
# The epilogue warpgroups' chunk fold
# ---------------------------------------------------------------------------


def _fold_mirror(x, mlp, fbv, act_kind="quick_gelu"):
    """gemm_s8_epi_chunk_kernel's arithmetic on the twin's own codes, on
    ``mlp_plan``'s padded layout: each padded chunk's exact int32 product,
    deq_c = (acc_c * hs[m, c]) * s2, summed in f32 from 0 in chunk order,
    then bf16((x + b2) + sum).  Returns (mirror, twin)."""
    ls, lb, w1, w1s, b1, w2, w2s, b2 = mlp
    b, s, d = x.shape
    f = w1s.numel()
    plan = fb.mlp_plan(d, f, fbv)
    sk = {}
    twin = fbq.mlp_block_q_plain(x, *mlp, act_kind=act_kind, fb=fbv, scratch=sk)
    m = b * s
    cols = plan.hidden_columns()
    hq = torch.zeros((m, plan.fp), dtype=torch.int8)
    hq[:, cols] = sk["hq"].reshape(m, f)
    hs = sk["hs"].reshape(m, plan.k)
    w2p = torch.zeros((plan.fp, d), dtype=torch.int8)
    w2p[cols] = w2
    total = torch.zeros((m, d), dtype=torch.float32)
    for c in range(plan.k):
        sl = slice(c * plan.fbp, (c + 1) * plan.fbp)
        acc = torch._int_mm(hq[:, sl].contiguous(), w2p[sl].contiguous())
        total = total + (acc.float() * hs[:, c:c + 1]) * w2s.reshape(-1)
    out = (x.reshape(m, d).float() + b2) + total
    return out.to(x.dtype).reshape(b, s, d), twin


@pytest.mark.parametrize("act_kind", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("fbv,f", [(1536, 3072), (768, 3072), (1024, 3072), (192, 3072),
                                   (1076, 4304)])
def test_the_chunk_fold_mirror_is_the_twin(fbv, f, act_kind):
    """The kernel's fold, its padded chunks (1,076 -> 1,152, 192 -> 256) and
    its order (the sum from 0, the residual and bias added last) give
    ``mlp_block_q_plain(fb=)``'s output bit for bit."""
    d = 64
    mlp = [_t(a) for a in _mlp(d, f, seed=fbv)]
    x = _t(_x(2, 33, d, seed=f + fbv), torch.bfloat16)
    got, twin = _fold_mirror(x, mlp, fbv, act_kind)
    assert torch.equal(got, twin)


def test_the_fold_is_the_sources():
    """The epilogue's fold is gemm_s8_kernel's EQ_RESID_BIAS_CHUNK, operation
    for operation: the sum from 0.f (chunk 0 adds to zeros, later chunks to
    the kept sums), (acc * row scale of the chunk) * channel scale, the
    residual and bias first, the sum last."""
    src = _source()
    kern = _between(src, "gemm_s8_epi_chunk_kernel(const __grid_constant__",
                    "bool fsplit_down_fits(int D, int chunk)")
    assert "float v[4] = {0.f, 0.f, 0.f, 0.f};" in kern
    assert "for (int i = 0; i < 4; ++i) hi[k][i] = 0.f;" in kern
    assert "if (c > 0) *reinterpret_cast<float4*>(v) = *lo;" in kern
    assert "v[i] = __fadd_rn(v[i], __fmul_rn(__fmul_rn(__int2float_rn(a[i]), rs), cs[i]));" in kern
    assert ("hi[k][i] = __fadd_rn(hi[k][i],\n"
            "                               __fmul_rn(__fmul_rn(__int2float_rn(a[4 + i]), rs), "
            "cs[4 + i]));") in kern
    assert "const float rs = m < M ? a_scale[m * nchunks + c] : 0.f;" in kern
    assert ("pw[i] = pack_bf16(__fadd_rn(__fadd_rn(x[2 * i], bb[2 * i]), v[2 * i]),"
            in kern)
    old = _between(src, "gemm_s8_kernel(const __grid_constant__", "cudaError_t launch_gemm_s8(")
    assert "facc[i] = 0.f;" in old and "facc[a] = __fadd_rn(facc[a], p);" in old
    assert "o[i] = __fadd_rn(__fadd_rn(rr[i], bb[i]), d[i]);" in old


# ---------------------------------------------------------------------------
# The hand-offs between the consumers and the epilogue warpgroups
# ---------------------------------------------------------------------------


def _half_offset(r, col):
    """csrc/fused_block_q.cu::te_half_offset."""
    return (col >> 5) * TG_BOX + r * 128 + ((((col & 31) >> 2) ^ r) & 7) * 16 + (col & 3) * 4


def _consumer_elements():
    """The int32 elements (byte offsets, 8 bytes) a consumer warpgroup's
    threads write: wgmma's accumulator layout, as the kernel dumps it."""
    for warp in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for j in range(SBN // 8):
                for h in range(2):
                    yield _half_offset(16 * warp + g + 8 * h, 8 * j + 2 * t)


def _epilogue_elements():
    """The 16-byte reads of an epilogue warpgroup's threads: columns 8 cg ..
    8 cg + 7 of rows rr + 8 k."""
    for tid in range(128):
        cg, rr = tid & 15, tid >> 4
        for k in range(8):
            for c0 in (8 * cg, 8 * cg + 4):
                yield _half_offset(rr + 8 * k, c0)


class _Barrier:
    """An mbarrier of arrival count 1: wait(parity) passes while the current
    phase's parity differs from ``parity`` (the phase of that parity has
    completed, as try_wait.parity reads it)."""

    def __init__(self):
        self.completed = 0

    def passes(self, parity):
        return (self.completed & 1) != parity


def _simulate(nchunks, tiles, seed):
    """One consumer and one epilogue warpgroup of gemm_s8_epi_chunk_kernel
    stepped in a random interleaving: the consumer waits ``freed`` for
    hand-off h - 1 before dumping hand-off h, the epilogue waits ``dumped``
    for h, reads it and arrives ``freed``.  Returns the hand-offs each side
    saw and the barriers' phase counts; asserts each wait passes only on its
    own hand-off's phase and each element holds the hand-off it is read in."""
    rng = random.Random(seed)
    dumped, freed = _Barrier(), _Barrier()
    buf = {}
    total = nchunks * tiles
    cons = {"hand": 0, "state": "wait"}
    epi = {"hand": 0, "state": "wait"}
    reads = []
    steps = 0
    while cons["hand"] < total or epi["hand"] < total:
        steps += 1
        assert steps < 100 * total + 100, "deadlock"
        actor = rng.choice([a for a, st in (("c", cons), ("e", epi)) if st["hand"] < total])
        if actor == "c":
            h = cons["hand"]
            if cons["state"] == "wait":
                if h > 0 and not freed.passes((h - 1) & 1):
                    continue
                assert h == 0 or freed.completed == h  # its own phase, not an alias
                cons["state"] = "dump"
            else:  # dump the chunk's tile, arrive
                for at in _consumer_elements():
                    buf[at] = h
                dumped.completed += 1
                cons["hand"] += 1
                cons["state"] = "wait"
        else:
            h = epi["hand"]
            if epi["state"] == "wait":
                if not dumped.passes(h & 1):
                    continue
                assert dumped.completed == h + 1
                epi["state"] = "read"
            else:
                seen = {buf[at] for at in _epilogue_elements()}
                assert seen == {h}  # every element of this hand-off, none of the next
                reads.append(h)
                freed.completed += 1
                epi["hand"] += 1
                epi["state"] = "wait"
    return reads, dumped.completed, freed.completed


@pytest.mark.parametrize("nchunks", [1, 2, 3, 4, 9, 16])
@pytest.mark.parametrize("tiles", [1, 3])
def test_the_hand_offs_under_any_interleaving(nchunks, tiles):
    """k hand-offs a tile through one half buffer: under random interleavings
    of the two sides each wait passes on its own hand-off's phase (parity
    never aliased to the next one), the epilogue reads hand-offs 0, 1, ...
    in order and each phase flips once a hand-off: k tiles times."""
    for seed in range(4):
        reads, nd, nf = _simulate(nchunks, tiles, seed)
        assert reads == list(range(nchunks * tiles))
        assert nd == nf == nchunks * tiles


def test_the_half_buffer_is_written_and_read_once_a_hand_off():
    """One hand-off: the consumers' int2 writes and the epilogue threads'
    16-byte reads cover the 64 x 128 int32 half once each, at the same
    bytes."""
    written, read = collections.Counter(), collections.Counter()
    for at in _consumer_elements():
        written.update(range(at, at + 8))
    for at in _epilogue_elements():
        assert at % 16 == 0
        read.update(range(at, at + 16))
    assert written == read and len(written) == 64 * SBN * 4 and set(written.values()) == {1}


def _stage_offset(r, col):
    """csrc/fused_block_q.cu::tg_stage_offset."""
    return (col >> 6) * TG_BOX + r * 128 + ((((col & 63) >> 3) ^ r) & 7) * 16 + (col & 7) * 2


def _sum_offset(r, col):
    """csrc/fused_block_q.cu::tc_sum_offset: an epilogue warpgroup's shared
    f32 sum (r, col), col % 8 < 4 (columns 4-7 of each group stay in the
    thread's registers): the staging's 16-byte unit of (r, col & ~7)."""
    assert col & 4 == 0
    return _stage_offset(r, col & ~7) + (col & 3) * 4


def test_the_shared_sums_cover_the_staging_each_unit_its_threads():
    """The shared sums (columns 0-3 of each 8-column group, 64 rows) fill the
    16 KB staging once each, a thread's four sums of a row one 16-byte unit;
    the bf16 row unit (r, 8 cg) a thread stages is the unit of its own sums,
    which it has read: the staging is written only over the writer's own
    sums, and no two threads share a unit."""
    seen = collections.Counter()
    owner = {}
    for tid in range(128):
        cg, rr = tid & 15, tid >> 4
        for k in range(8):
            r = rr + 8 * k
            at = _sum_offset(r, 8 * cg)
            assert at % 16 == 0 and [_sum_offset(r, 8 * cg + i) for i in range(4)] == [
                at, at + 4, at + 8, at + 12]
            for b in range(at, at + 16):
                seen[b] += 1
                owner[b] = tid
            assert _stage_offset(r, 8 * cg) == at
    assert len(seen) == 64 * SBN * 2 and set(seen.values()) == {1}
    assert max(seen) == 2 * TG_BOX - 1  # the two [64][64] boxes the TMA stores read
    src = _source()
    fn = _between(src, "__device__ __forceinline__ int tc_sum_offset(int r, int col) {", "\n}\n")
    assert "return tg_stage_offset(r, col & ~7) + (col & 3) * 4;" in fn
    kern = _between(src, "gemm_s8_epi_chunk_kernel(const __grid_constant__",
                    "bool fsplit_down_fits(int D, int chunk)")
    assert "*lo = packed;  // the staging unit (r, 8 cg): this thread's own sums, read above" in kern
    assert "tma_store_2d(&tm_c, stage + b * TG_BOX, n0 + 64 * b, row0);" in kern
    assert "float hi[8][4];" in kern and "for (int i = 0; i < 4; ++i) v[4 + i] = hi[k][i];" in kern
    # the next tile's sums overwrite the staging only once the stores have read it
    at = kern.index("tma_store_wait<true>();  // the last tile's stores have read the staging")
    assert at < kern.index("for (int c = 0; c < nchunks; ++c, ++hand) {")


@pytest.mark.parametrize("chunk_steps,nk", [(12, 24), (6, 24), (8, 24), (2, 32), (9, 36),
                                            (4, 8)])
def test_each_stage_is_handed_back_once(chunk_steps, nk):
    """The consumers' K loop (mirrored): a stage goes back to the producer
    after the next stage's products are issued, and at a chunk's end once
    its products are done: every K step's stage exactly once, over three
    tiles."""
    arrivals = collections.Counter()
    it = 0
    for _ in range(3):
        prev = -1
        for kt in range(nk):
            if prev >= 0:
                arrivals[prev] += 1
            prev = it
            it += 1
            if (kt + 1) % chunk_steps:
                continue
            arrivals[prev] += 1
            prev = -1
        assert prev == -1  # a tile ends at a chunk's end: nothing left to hand back
    assert sorted(arrivals) == list(range(it)) and set(arrivals.values()) == {1}


def test_the_hand_offs_are_the_sources():
    src = _source()
    kern = _between(src, "gemm_s8_epi_chunk_kernel(const __grid_constant__",
                    "bool fsplit_down_fits(int D, int chunk)")
    for line in ("if ((kt + 1) % chunk_steps) continue;",
                 "if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);",
                 "if (tid == 0) mbar_arrive(&empty[prev]);\n        prev = -1;",
                 "if (hand > 0) mbar_wait(&freed[wg], (hand - 1) & 1);",
                 "half + te_half_offset(warp * 16 + g + 8 * h, 8 * j + 2 * t)",
                 "if (tid == 0) mbar_arrive(&dumped[wg]);\n        ++hand;",
                 "for (int c = 0; c < nchunks; ++c, ++hand) {",
                 "mbar_wait(&dumped[e], hand & 1);",
                 "half + te_half_offset(r, 8 * cg)", "te_half_offset(r, 8 * cg + 4)",
                 "if (tid == 0) mbar_arrive(&freed[e]);",
                 "const int e = wg - 2, cg = tid & 15, rr = tid >> 4;",
                 "mbar_init(&dumped[h], 1);", "mbar_init(&freed[h], 1);",
                 "const int nk = K / SBK, nchunks = nk / chunk_steps;"):
        assert line in kern, line
    assert "constexpr int TE_STAGES = 4;" in src  # the chunk kernel shares the ring


# ---------------------------------------------------------------------------
# The persistent walk at the F-split's shapes
# ---------------------------------------------------------------------------


def _band(nt, k):
    """csrc/fused_block_q.cu::tg_band."""
    return max(1, min(nt, BAND_BYTES // (SBN * k)))


def _tile(tile, mt, nt, band):
    """csrc/fused_block_q.cu::tg_tile."""
    b = tile // (mt * band)
    first = b * band
    w = min(band, nt - first)
    r = tile - b * mt * band
    return (r // w) * SBM, (first + r % w) * SBN


@pytest.mark.parametrize("m,d,f,fbv", [(256 * 197, 768, 3072, 1536), (256 * 197, 768, 3072, 768),
                                       (32 * 785, 768, 3072, 1024), (8 * 197, 768, 3072, 192),
                                       (8 * 257, 1152, 4304, 1076), (8 * 77, 200, 800, 400)])
def test_the_walk_covers_every_tile_once(m, d, f, fbv):
    """The down product's tiles (N = D rounded up to 128, K = the padded
    hidden) over min(tiles, 132) persistent blocks: every tile once."""
    plan = fb.mlp_plan(d, f, fbv)
    mt, nt, k = -(-m // SBM), plan.no // SBN, plan.fp
    band, tiles = _band(nt, k), mt * nt
    grid = min(tiles, SMS)
    seen = collections.Counter()
    for block in range(grid):
        seen.update(_tile(t, mt, nt, band) for t in range(block, tiles, grid))
    assert len(seen) == tiles and set(seen.values()) == {1}
    assert k % (plan.fbp) == 0 and plan.fbp % SBK == 0  # whole chunks of whole K steps
    src = _source()
    kern = _between(src, "gemm_s8_epi_chunk_kernel(const __grid_constant__",
                    "bool fsplit_down_fits(int D, int chunk)")
    assert kern.count("tg_tile(tile, mt, nt, band, m0, n0);") == 2  # producer and epilogue
    launch = _between(src, "cudaError_t launch_gemm_s8_epi_chunk(", "\n}\n")
    assert "tiles < g_sm_count ? tiles : g_sm_count" in launch and "chunk / SBK" in launch


# ---------------------------------------------------------------------------
# The launches, routes and counters
# ---------------------------------------------------------------------------


def test_the_entries_run_four_launches():
    """The F-split and bf16h normalise and quantize x in one pass (xn not
    written), then the up product, the hidden's pass and the down product."""
    src = _source()
    impl = _between(src, "int mlp_block_q_impl(", "}  // namespace")
    assert "const bool ln_quant = k > 1 || variant == MQ_BF16H;" in impl
    at = impl.index("} else if (ln_quant) {")
    assert impl.index("launch_ln_quant(", at) < impl.index("} else {", at)
    assert ("e = tma ? launch_gemm_s8_tma(ixq, fxs, w1, fs1, fb1, static_cast<bf16*>(h), M, F, "
            "DK, st)") in impl
    assert "launch_gemm_s8_epi_chunk(ihq, fhs, w2, fs2, fb2, static_cast<const bf16*>(x)" in impl
    assert "launch_gemm_s8<EQ_RESID_BIAS_CHUNK>(" in impl  # the other route, off the rule
    entry = src[src.index("int dvl_mlp_block_q("):]
    assert "void* hs, int tma, int M, int D, int F, int act_kind, int k, void* stream)" in entry


def test_routes_are_counted_and_reset():
    assert set(fbq.FSPLIT_ROUTES) == {"epi", "gemm"} and set(fbq.BF16H_ROUTES) == {"tma", "gemm"}
    fbq.FSPLIT_ROUTES["epi"] += 1
    fbq.BF16H_ROUTES["tma"] += 2
    fbq.reset_launches()
    assert not any(fbq.FSPLIT_ROUTES.values()) and not any(fbq.BF16H_ROUTES.values())


@pytest.mark.parametrize("kind", ["fsplit", "bf16h"])
def test_cpu_calls_take_the_twin_and_count_no_route(kind):
    mlp = [_t(a) for a in _layer(64, seed=5)[1]]
    x = _t(_x(2, 9, 64, seed=6), torch.bfloat16)
    fbq.reset_launches()
    sk = {}
    if kind == "fsplit":
        got = fbq.mlp_block_q(x, *mlp, fb=128, scratch=sk)
        assert torch.equal(got, fbq.mlp_block_q_plain(x, *mlp, fb=128))
    else:
        got = fbq.mlp_block_q_bf16h(x, *mlp, scratch=sk)
        assert torch.equal(got, fbq.mlp_block_q_bf16h_plain(x, *mlp))
    assert not any(fbq.FSPLIT_ROUTES.values()) and not any(fbq.BF16H_ROUTES.values())
    assert not any(fbq.KB_LAUNCHES.values())
    assert "xn" in sk  # the twin keeps LayerNorm's rows


# ---------------------------------------------------------------------------
# chip_smoke.py's SASS check of the new GEMM, on a stand-in dump
# ---------------------------------------------------------------------------


def _smoke():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


CHUNK = ("_ZN12_GLOBAL__N_124gemm_s8_epi_chunk_kernelE14CUtensorMap_stS0_S0_PKfS2_S2_"
         "PK13__nv_bfloat16iiiiii")


@pytest.mark.parametrize("broken", [None, "no UTMASTG", "no IGMMA", "no UTMALDG", "IMMA",
                                    "missing"])
def test_the_sass_check_holds_the_chunk_gemm(monkeypatch, broken):
    """chip_smoke.sass_check_mlp_q: gemm_s8_epi_chunk_kernel holds s8 wgmma,
    TMA loads and TMA stores and no mma.sync; the two quantize passes hold no
    mma.sync either."""
    C = _smoke()
    body = {None: "IGMMA.64x128x32.S32.S8.S8 ; UTMALDG.2D ; UTMASTG.2D ;",
            "no UTMASTG": "IGMMA.64x128x32.S32.S8.S8 ; UTMALDG.2D ;",
            "no IGMMA": "UTMALDG.2D ; UTMASTG.2D ;",
            "no UTMALDG": "IGMMA.64x128x32.S32.S8.S8 ; UTMASTG.2D ;",
            "IMMA": "IGMMA.64x128x32.S32.S8.S8 ; UTMALDG.2D ; UTMASTG.2D ; IMMA.16832.S8.S8 ;",
            "missing": None}[broken]
    funcs = {"_ZN12_GLOBAL__N_120quant_rows_x4_kernelILi3EEEvPKfPaPfi": "LDG.E.128 ;",
             "_ZN12_GLOBAL__N_123qgelu_quant_rows_kernelILi3EEEvPK13__nv_bfloat16PaPfS4_i":
             "LDG.E.128 ; MUFU.EX2 ;"}
    if body is not None:
        funcs[CHUNK] = body
    dump = "".join(f"\n\tFunction : {name}\n{b}\n" for name, b in funcs.items())
    monkeypatch.setattr(C, "find_cuobjdump", lambda: "cuobjdump")
    monkeypatch.setattr(C.subprocess, "run",
                        lambda *a, **k: types.SimpleNamespace(stdout=dump, returncode=0))
    assert C.SASS_PER_KERNEL_MLP_Q["fused_block_q"] == (
        ("gemm_s8_epi_chunk_kernel", ("IGMMA", "UTMALDG", "UTMASTG"), 1),)
    if broken is None:
        C.sass_check_mlp_q("lib.so")
    else:
        with pytest.raises(RuntimeError):
            C.sass_check_mlp_q("lib.so")


# ---------------------------------------------------------------------------
# The twins against JAX's kernels at widths the other files do not take
# ---------------------------------------------------------------------------


DTYPES = ["float32", "bfloat16"]


def _dt(dtype):
    import jax.numpy as jnp

    return getattr(jnp, dtype), getattr(torch, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,f,fbv", [(768, 3072, 1024), (768, 3072, 192), (1152, 4304, 1076)])
def test_fsplit_matches_jax_mlp_block_q(d, f, fbv, dtype):
    """``mlp_block_q(fb=)`` against JAX's in interpret mode at fb = 1,024
    (k = 3), 192 (k = 16) and SigLIP-So400m's 1,076 (F / 4), under the KB
    tests' full-width bars."""
    from debias_vision_lang_tpu.ops import fused_block_q as jfbq

    jdt, tdt = _dt(dtype)
    mlp = _mlp(d, f, seed=fbv)
    x = _x(1, 33, d, seed=fbv + 1)
    ref = jfbq.mlp_block_q(_jnp(x, jdt), *map(_jnp, mlp), bb=1, fb=fbv, interpret=True)
    got = fbq.mlp_block_q(_t(x, tdt), *map(_t, mlp), fb=fbv)
    check(got, ref, dtype, full_width=True)


@pytest.fixture(scope="module")
def captured():
    return capture(("q_ilp", "q_mlp_bf16h"), {"ILP_BATCH": 4, "ILP_STEPS": 1})


@pytest.mark.parametrize("dtype", DTYPES)
def test_fsplit_matches_make_fsplit_body_at_k3(captured, dtype):
    """``make_fsplit(k)``'s ``mlp_fsplit_kernel`` at k = 3 (fb = 1,024, the
    FiT joint shape's tile) on ViT-B/16's width."""
    jdt, tdt = _dt(dtype)
    kern = functools.partial(captured["mlp_fsplit_kernel"][0].func, k=3)
    mlp = _layer(768, seed=29)[1]
    x = _x(2, 65, 768, seed=30)
    ref = interpret(kern, _jnp(x, jdt), _pallas_ops(mlp))
    got = fbq.mlp_block_q(_t(x, tdt), *map(_t, mlp), fb=1024)
    check(got, ref, dtype, full_width=True)


@pytest.mark.parametrize("dtype", DTYPES)
def test_bf16h_matches_pipe_kernel_at_siglip_width(captured, dtype):
    """``pipe_kernel`` with bf16h (KB (a) 2) at SigLIP-So400m's D = 1,152, F =
    4,304 (the card's 4,352 padded lanes: 5 units a thread of the
    gelu-and-quantize pass)."""
    jdt, tdt = _dt(dtype)
    kern = functools.partial(captured["pipe_kernel"][0].func, bb=1, depth=2, bf16h=True)
    mlp = _mlp(1152, 4304, seed=31)
    x = _x(2, 17, 1152, seed=32)
    ref = interpret(kern, _jnp(x, jdt), _pallas_ops(mlp))
    got = fbq.mlp_block_q_bf16h(_t(x, tdt), *map(_t, mlp))
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


def _on(dev, mlp):
    t = [_t(a).to(dev) for a in mlp]
    return t, {"w1_qt": t[2].t().contiguous(), "w2_qt": t[5].t().contiguous()}


@pytest.mark.cuda
@pytest.mark.parametrize("kind,d,f,fbv,b,s", [
    ("fsplit", 768, 3072, 1536, 4, 197), ("fsplit", 768, 3072, 768, 3, 77),
    ("fsplit", 768, 3072, 1024, 2, 197), ("fsplit", 768, 3072, 192, 2, 50),
    ("fsplit", 1152, 4304, 1076, 2, 257), ("fsplit", 200, 800, 400, 3, 77),
    ("fsplit", 203, 812, 406, 2, 77), ("fsplit", 1032, 4128, 1032, 2, 50),
    ("bf16h", 768, 3072, None, 4, 197),
    ("bf16h", 1152, 4304, None, 2, 257), ("bf16h", 200, 800, None, 3, 77)])
def test_cuda_both_routes_bit_equal(cuda, kind, d, f, fbv, b, s):
    """The default route and the s8 GEMM route give the same output, codes,
    scales and rows bit for bit; each call counted on its route; no
    LayerNorm rows; every code the quantization of the kernel's own rows
    (LayerNorm's: K4's own of the same x, the same kernel's rows)."""
    mlp, kw = _on(cuda, _mlp(d, f, seed=d + s))
    x = torch.from_numpy(_x(b, s, d, seed=s)).to(cuda, torch.bfloat16)
    fbq.reset_launches()
    sk, so = {}, {}
    cuda_kind = "bf16h" if kind == "bf16h" else "k4"
    if kind == "bf16h":
        got = fbq.mlp_block_q_bf16h(x, *mlp, **kw, scratch=sk)
    else:
        got = fbq.mlp_block_q(x, *mlp, fb=fbv, **kw, scratch=sk)
    (ls, lb, _, w1s, b1, _, w2s, b2) = mlp
    other = fbq._mlp_block_q_cuda(x, ls, lb, w1s, b1, w2s, b2, "quick_gelu", kw["w1_qt"],
                                  kw["w2_qt"], so, kind=cuda_kind, fb=fbv, tma=False)
    torch.cuda.synchronize()
    assert torch.equal(got, other) and set(sk) == set(so) and "xn" not in sk
    assert all(torch.equal(sk[k], so[k]) for k in sk)
    if kind == "bf16h":
        assert fbq.BF16H_ROUTES == {"tma": 1, "gemm": 1}
        assert fbq.KB_LAUNCHES["mlp_block_q_bf16h"] == 2
    else:
        route = _route(d, fbv)
        assert fbq.fsplit_route(d, fbv) == route
        assert fbq.FSPLIT_ROUTES == {"epi": 0, "gemm": 1, route: 1 + (route == "gemm")}
        assert fbq.KB_LAUNCHES["mlp_block_q_fsplit"] == 2
    s4 = {}
    fbq.mlp_block_q(x, *mlp, **kw, scratch=s4)  # K4: LayerNorm's rows of the same x
    for codes, rows, scales in (("xq", s4["xn"], "xs"), ("hq", sk["h"], "hs")):
        q, sc = fbq.quant_rows(rows)
        assert torch.equal(q, sk[codes]) and torch.equal(sc, sk[scales]), codes
    assert torch.equal(sk["xq"], s4["xq"]) and torch.equal(sk["xs"], s4["xs"])


@pytest.mark.cuda
def test_cuda_bit_equal_to_the_parent_design(cuda):
    """Every output, code, scale and row of benchmarks_torch/mlp_q_split.py's
    cases and both 12-layer towers bit-equal to mlp_q_parent.json, the
    design before the redesign."""
    spec = importlib.util.spec_from_file_location(
        "mlp_q_split", REPO / "benchmarks_torch" / "mlp_q_split.py")
    M = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(M)
    parent = json.loads((REPO / "benchmarks_torch" / "mlp_q_parent.json").read_text())
    assert M.output_digests(fbq, cuda) == parent["outputs"]
