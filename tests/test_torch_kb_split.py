"""K4's F-split (``mlp_block_q(fb=)``, KB (a) 7), KB (a) 5
(``attention_block_opt``) and the one-call int8 layer of
``benchmarks/q_layer_fused.py`` in the PyTorch port, against their JAX
and Pallas counterparts on the CPU.

  * ``mlp_block_q(fb=F/k)`` against JAX's ``mlp_block_q(fb=F/k,
    interpret=True)`` for k = 1, 2, 4, both activations, at B=2 S=13 D=32
    (float32 at atol 1e-4) and at ViT-B/16's width B=1 S=197 D=768 (the
    full-width bars of ``tests/kb_helpers.py``); bfloat16 within one bf16
    ulp.  JAX accumulates the chunks as ((x + b2) + p0) + p1 ...; the port
    (twin and kernel) sums the chunks first, (x + b2) + (p0 + p1 ...),
    ``make_fsplit``'s order: the two differ in f32 rounding only.
  * ``make_fsplit(k)``'s ``mlp_fsplit_kernel`` (benchmarks/q_ilp.py) and
    ``layer_kernel`` (benchmarks/q_layer_fused.py, all three modes) are
    closures of their scripts' ``main()``: captured by
    ``kb_helpers.capture`` (ILP_BATCH 4, ILP_STEPS 1) and run in interpret
    mode on 2 batch items at their own width (S=197, D=768, H=12, F=3072).
  * ``attention_block_opt`` from benchmarks/attn_variants.py with its
    ``pallas_call`` in interpret mode, at small widths and at full width;
    ``prescale_qkv`` against the script's, bit for bit.
  * What the split changes: each chunk's rows get their own scale, so the
    codes differ from the unsplit quantization where the chunks' amaxes
    differ, and not where they are equal; ``fb`` = None or F is K4.
  * What the layer changes: at bfloat16 it skips K3's rounding of x +
    proj, so it is not K3 then K4; at float32 it is, bit for bit.
  * The refusals (F % fb on every route, with JAX's message; the card
    takes any divisor fb of F, each chunk padded to 128 lanes), the
    counters, the sources.
  * CUDA (marker ``cuda``): each kernel against its twin at full width.

    python -m pytest tests/test_torch_kb_split.py -q -p no:randomly
"""

import functools
import pathlib

import numpy as np
import pytest
import torch

from debias_vision_lang_torch.ops import fused_block as fb
from debias_vision_lang_torch.ops import fused_block_q as fbq
from kb_helpers import (_jnp, _layer, _np32, _pallas_ops, _t, _x, capture, check, interpret,
                        load, within_one_ulp)

torch.set_num_threads(1)

CSRC = pathlib.Path(fbq.__file__).resolve().parent.parent / "csrc"
S, D, H, F = 197, 768, 12, 3072  # ViT-B/16: the closures' width
DTYPES = ["float32", "bfloat16"]


@pytest.fixture(scope="module")
def captured():
    return capture(("q_ilp", "q_layer_fused"), {"ILP_BATCH": 4, "ILP_STEPS": 1})


@pytest.fixture(scope="module")
def full_block():
    return _layer(D, seed=11)


def _dt(dtype):
    import jax.numpy as jnp

    return getattr(jnp, dtype), getattr(torch, dtype)


# ---------------------------------------------------------------------------
# 1. K4's F-split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("act_kind", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("b,s,d", [(2, 13, 32), (1, S, D)])
def test_fsplit_matches_jax_mlp_block_q(b, s, d, act_kind, k, dtype):
    from debias_vision_lang_tpu.ops import fused_block_q as jfbq

    jdt, tdt = _dt(dtype)
    mlp = _layer(d, seed=d)[1]
    x = _x(b, s, d, seed=k)
    f = 4 * d
    ref = jfbq.mlp_block_q(_jnp(x, jdt), *map(_jnp, mlp), act_kind=act_kind, bb=1, fb=f // k,
                           interpret=True)
    got = fbq.mlp_block_q(_t(x, tdt), *map(_t, mlp), act_kind=act_kind, fb=f // k)
    check(got, ref, dtype, full_width=d == D)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [2, 4])
def test_fsplit_matches_make_fsplit_body(captured, full_block, k, dtype):
    jdt, tdt = _dt(dtype)
    kern = functools.partial(captured["mlp_fsplit_kernel"][0].func, k=k)
    x = _x(2, S, D, seed=20 + k)
    mlp = full_block[1]
    ref = interpret(kern, _jnp(x, jdt), _pallas_ops(mlp))
    got = fbq.mlp_block_q(_t(x, tdt), *map(_t, mlp), fb=F // k)
    check(got, ref, dtype, full_width=True)


def test_recorder_ran_the_split_and_layer_bodies(captured):
    assert [p.keywords for p in captured["mlp_fsplit_kernel"]] == [{"k": 2}, {"k": 4}]
    assert [p.keywords for p in captured["layer_kernel"]] == [
        {"bb": 2, "mode": "seq"}, {"bb": 2, "mode": "xpipe"}, {"bb": 4, "mode": "seq"}]
    assert captured.bb["mlp_fsplit_kernel"] == [1, 1]
    assert captured.bb["layer_kernel"] == [2, 2, 4]


def test_fb_none_and_fb_f_are_k4():
    mlp = [_t(a) for a in _layer(32)[1]]
    x = _t(_x(2, 9, 32), torch.bfloat16)
    sk = {}
    ref = fbq.mlp_block_q(x, *mlp)
    for fbv in (None, 128):
        got = fbq.mlp_block_q(x, *mlp, fb=fbv, scratch=sk)
        assert torch.equal(got, ref)
        assert sk["hq"].shape == (2, 9, 128) and sk["hs"].shape == (2, 9, 1)
    fbq.mlp_block_q(x, *mlp, fb=32, scratch=sk)
    assert sk["hq"].shape == (2, 9, 4, 32) and sk["hs"].shape == (2, 9, 4, 1)
    assert torch.equal(fbq.quant_rows(sk["h"])[0], sk["hq"])


def test_chunked_quantization_differs_where_chunk_amaxes_differ():
    """Chunks of one hidden row with other amaxes get other scales, so codes
    change in the chunks whose amax is below the row's (the small chunk's
    codes are finer, and the sums differ); with every chunk's amax equal to
    the row's the codes are the unsplit ones and the sums agree to f32
    rounding."""
    rng = np.random.default_rng(3)
    w2 = torch.from_numpy(rng.integers(-127, 128, size=(256, 64)).astype(np.int8))
    w2s = torch.from_numpy(rng.uniform(0.001, 0.01, size=(1, 64)).astype(np.float32))
    h = torch.from_numpy(rng.normal(size=(3, 5, 256)).astype(np.float32))
    h[..., :128] *= 20.0
    part, hq, hs = fbq.fsplit_down(h, w2, w2s, 128)
    q1, s1 = fbq.quant_rows(h)
    whole = fbq.dot_q(q1, s1, w2, w2s)
    assert (hs[..., 1, 0] < hs[..., 0, 0] / 4).all()
    assert torch.equal(hq[..., 0, :], q1[..., :128])
    assert (hq[..., 1, :] != q1[..., 128:]).float().mean() > 0.5
    assert (part - whole).abs().max() > 1e-3
    # equal chunk amaxes: the same codes and scales
    h2 = h.clone()
    h2[..., :128] /= 20.0
    h2[..., 0] = h2[..., 128] = 9.0
    part2, hq2, hs2 = fbq.fsplit_down(h2, w2, w2s, 128)
    q2, s2 = fbq.quant_rows(h2)
    assert torch.equal(hq2.reshape(q2.shape), q2) and torch.equal(hs2[..., 0, :], s2)
    torch.testing.assert_close(part2, fbq.dot_q(q2, s2, w2, w2s), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("fbv", [100, 0, 512])
def test_fb_must_divide_f(fbv):
    """Every route refuses an fb that does not divide F, with JAX's message
    (JAX's mlp_block_q raises the same for 100 and 512)."""
    mlp = [_t(a) for a in _layer(32)[1]]
    x = _t(_x(1, 4, 32))
    with pytest.raises(ValueError, match=f"mlp dim 128 not divisible by fb={fbv}"):
        fbq.mlp_block_q(x, *mlp, fb=fbv)
    if fbv:
        from debias_vision_lang_tpu.ops import fused_block_q as jfbq

        with pytest.raises(ValueError, match=f"mlp dim 128 not divisible by fb={fbv}"):
            jfbq.mlp_block_q(_jnp(_x(1, 4, 32)), *map(_jnp, _layer(32)[1]), fb=fbv,
                             interpret=True)


# ---------------------------------------------------------------------------
# 2. KB (a) 5, attention_block_opt
# ---------------------------------------------------------------------------


@pytest.fixture
def attn_variants(monkeypatch):
    """benchmarks/attn_variants.py with its pallas_call in interpret mode."""
    mod = load("attn_variants")
    monkeypatch.setattr(mod.pl, "pallas_call",
                        functools.partial(mod.pl.pallas_call, interpret=True))
    return mod


def _bf16_block(d, seed):
    """A bf16 block's attention tensors (f32 numpy): LN, wqkv, bqkv, wo, bo."""
    rng = np.random.default_rng(seed)

    def rn(*shape, std=1.0):
        return (rng.normal(size=shape) * std).astype(np.float32)

    return (1 + rn(d, std=0.1), rn(d, std=0.1), rn(d, 3 * d, std=d ** -0.5),
            rn(3 * d, std=0.1), rn(d, d, std=d ** -0.5), rn(d, std=0.1))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,d,heads", [(3, 13, 32, 2), (2, 50, 64, 1), (1, S, D, H)])
def test_opt_matches_the_pallas_kernel(attn_variants, b, s, d, heads, dtype):
    jdt, tdt = _dt(dtype)
    ls, lb, wqkv, bqkv, wo, bo = _bf16_block(d, seed=d + heads)
    wq, bq = attn_variants.prescale_qkv(_jnp(wqkv), _jnp(bqkv), d, heads)
    x = _x(b, s, d, seed=5)
    ref = attn_variants.attention_block_opt(_jnp(x, jdt), _jnp(ls), _jnp(lb), wq, bq, _jnp(wo),
                                            _jnp(bo), heads=heads)
    got = fb.attention_block_opt(_t(x, tdt), _t(ls), _t(lb), _t(np.asarray(wq)),
                                 _t(np.asarray(bq)), _t(wo), _t(bo), heads=heads)
    if dtype == "bfloat16":
        within_one_ulp(got, ref)
    else:  # no int8 codes to flip: float32 rounding alone, at every width
        np.testing.assert_allclose(_np32(got), _np32(ref), atol=1e-4)


def test_prescale_qkv_is_the_scripts_bit_for_bit(attn_variants):
    ls, lb, wqkv, bqkv, wo, bo = _bf16_block(D, seed=2)
    wq, bq = attn_variants.prescale_qkv(_jnp(wqkv), _jnp(bqkv), D, H)
    got_w, got_b = fb.prescale_qkv(_t(wqkv), _t(bqkv), D, H)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(bq))
    assert torch.equal(got_w[:, D:], _t(wqkv)[:, D:])


def test_opt_is_the_prescaled_core_of_kb_a6():
    """(a) 5 and (a) 6 share their attention (``prescaled_core``): with all
    heads in one group, (a) 6 differs only in summing the out-projection
    head by head in f32 and adding bo to x first."""
    ls, lb, wqkv, bqkv, wo, bo = map(_t, _bf16_block(64, seed=4))
    wq, bq = fb.prescale_qkv(wqkv, bqkv, 64, 1)
    x = _t(_x(2, 9, 64), torch.float32)
    opt = fb.attention_block_opt(x, ls, lb, wq, bq, wo, bo, heads=1)
    one = fb.attention_block_heads_plain(x, ls, lb, wq, bq, wo, heads=1, prescaled=True, bo=bo)
    torch.testing.assert_close(opt, one, atol=1e-5, rtol=1e-6)


# ---------------------------------------------------------------------------
# 3. The one-call int8 layer of q_layer_fused.py
# ---------------------------------------------------------------------------


def _layer_args(block):
    attn, mlp = block
    return [*attn, *mlp]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["seq", "prod", "xpipe"])
def test_layer_matches_layer_kernel(captured, full_block, mode, dtype):
    jdt, tdt = _dt(dtype)
    kern = functools.partial(captured["layer_kernel"][0].func, bb=2, mode=mode)
    ls1, lb1, wq, wqs, bq, wo, wos, bo = full_block[0]
    ops = tuple(map(_jnp, (ls1[None], lb1[None], wq, wqs.reshape(1, -1), bq[None], wo,
                           wos.reshape(1, -1), bo[None]))) + _pallas_ops(full_block[1])
    x = _x(2, S, D, seed=30)
    ref = interpret(kern, _jnp(x, jdt), ops, bb=2)
    got = fbq.fused_layer_q(_t(x, tdt), *map(_t, _layer_args(full_block)), heads=H)
    check(got, ref, dtype, full_width=True)


def test_layer_skips_k3s_rounding(full_block):
    """At bfloat16 the layer is not K3 then K4: K3 rounds x + proj to bf16
    before K4's residual add, the layer keeps it f32 (LayerNorm reads the
    same bf16(y) in both), so some outputs differ, by at most the half ulp
    of y K3 drops plus the two outputs' own roundings.  At float32 both are
    one function, bit for bit."""
    attn, mlp = [_t(a) for a in full_block[0]], [_t(a) for a in full_block[1]]
    x = _t(_x(2, S, D, seed=31), torch.bfloat16)
    sk = {}
    layer = fbq.fused_layer_q(x, *attn, *mlp, heads=H, scratch=sk)
    chain = fbq.mlp_block_q(fbq.attention_block_q(x, *attn, heads=H), *mlp)
    diff = (layer.float() - chain.float()).abs()
    assert diff.ne(0).float().mean() > 1e-3
    assert (diff <= (sk["y"].abs() * 2.0 ** -8 + layer.float().abs() * 2.0 ** -7) * 1.01).all()
    assert sk["y"].dtype == torch.float32
    assert torch.equal(sk["y"].to(torch.bfloat16), fbq.attention_block_q(x, *attn, heads=H))
    x32 = x.float()
    assert torch.equal(fbq.fused_layer_q(x32, *attn, *mlp, heads=H),
                       fbq.mlp_block_q(fbq.attention_block_q(x32, *attn, heads=H), *mlp))


# ---------------------------------------------------------------------------
# Counters and sources
# ---------------------------------------------------------------------------


def test_cpu_twins_do_not_count():
    attn, mlp = [_t(a) for a in _layer(64)[0]], [_t(a) for a in _layer(64)[1]]
    x = _t(_x(2, 9, 64), torch.bfloat16)
    fb.reset_launches()
    fbq.reset_launches()
    fbq.mlp_block_q(x, *mlp, fb=128)
    fbq.fused_layer_q(x, *attn, *mlp, heads=1)
    ls, lb, wqkv, bqkv, wo, bo = map(_t, _bf16_block(64, seed=1))
    fb.attention_block_opt(x, ls, lb, wqkv, bqkv, wo, bo, heads=1)
    for mod in (fb, fbq):
        assert set(mod.KB_LAUNCHES.values()) == {0} and sum(mod.LAUNCHES.values()) == 0
    fb.KB_LAUNCHES["attention_block_opt"] = 2
    fb.reset_launches()
    assert fb.KB_LAUNCHES["attention_block_opt"] == 0


@pytest.mark.parametrize("lib,entry", [
    ("fused_block_q.cu", "dvl_mlp_block_q"), ("fused_block_q.cu", "dvl_fused_layer_q"),
    ("fused_block.cu", "dvl_attention_block_opt")])
def test_the_libraries_export_each_entry(lib, entry):
    src = (CSRC / lib).read_text()
    assert f"int {entry}(" in src
    if entry == "dvl_mlp_block_q":  # K4's entry takes the F-chunk count
        sig = src[src.index(f"int {entry}("):]
        assert "int act_kind, int k, void* stream)" in sig[:sig.index("{")]


def test_the_chunked_down_product_runs_on_the_s8_wgmma_gemm():
    """The F-split's products are the s8 wgmma GEMM's (the library's SASS
    check on the card forbids IMMA outside the int8 attention core): the
    hidden's quantize pass over the [M k, F / k] view, the down product in
    the chunked mode, each chunk flushed after its last wgmma retired."""
    cu = (CSRC / "fused_block_q.cu").read_text()
    impl = cu[cu.index("int mlp_block_q_impl("):cu.index("}  // namespace")]
    assert "launch_gemm_s8<EQ_RESID_BIAS_CHUNK>(" in impl and "M * k, F / k" in impl
    kern = cu[cu.index("gemm_s8_kernel(const __grid_constant__"):
              cu.index("cudaError_t launch_gemm_s8(")]
    flush = kern[kern.index("(kt + 1) % chunk_steps == 0"):]
    assert flush.index("wgmma_wait<0>();") < flush.index("facc[a] = __fadd_rn(facc[a], p);")
    assert "wgmma_ss_s8_n128(" in kern and "mma.sync" not in cu


# ---------------------------------------------------------------------------
# CUDA: the kernels against their twins on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled with nvcc "
                    "for sm_90a and have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _on(dev, arrays):
    return [_t(a).to(dev) for a in arrays]


def _codes_are_own(sk, pairs):
    for codes, rows, scales in pairs:
        q, s = fbq.quant_rows(sk[rows])
        assert torch.equal(q, sk[codes]) and torch.equal(s, sk[scales]), codes


@pytest.mark.cuda
@pytest.mark.parametrize("act_kind", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("fbv", [1536, 768])
@pytest.mark.parametrize("b,s", [(4, S), (3, 77)])
def test_cuda_fsplit_matches_twin(cuda, b, s, fbv, act_kind):
    mlp = _on(cuda, _layer(D, seed=8)[1])
    kw = {"w1_qt": mlp[2].t().contiguous(), "w2_qt": mlp[5].t().contiguous()}
    x = torch.from_numpy(_x(b, s, D, seed=fbv)).to(cuda, torch.bfloat16)
    fbq.reset_launches()
    sk = {}
    got = fbq.mlp_block_q(x, *mlp, act_kind=act_kind, fb=fbv, **kw, scratch=sk)
    torch.cuda.synchronize()
    assert fbq.KB_LAUNCHES["mlp_block_q_fsplit"] == 1 and fbq.LAUNCHES["mlp_block_q"] == 0
    assert sk["hs"].shape == (b, s, F // fbv, 1)
    s4 = {}  # one LayerNorm-and-quantize pass: K4's LayerNorm rows of the same x
    fbq.mlp_block_q(x, *mlp, **kw, scratch=s4)
    sk["xn"] = s4["xn"]
    _codes_are_own(sk, [("xq", "xn", "xs"), ("hq", "h", "hs")])
    own, _, _ = fbq.fsplit_down(sk["h"].reshape(b, s, F), mlp[5], mlp[6], fbv)
    within_one_ulp(got.cpu(), ((x.float() + mlp[7]) + own).to(torch.bfloat16).cpu())
    ref = fbq.mlp_block_q_plain(x, *mlp, act_kind=act_kind, fb=fbv)
    within_one_ulp(got.cpu(), ref.cpu())


@pytest.mark.cuda
def test_cuda_fsplit_takes_fb_off_the_k_step(cuda):
    """fb = 192 (off the s8 GEMM's K step): each chunk padded to 256 lanes,
    the output within one bf16 ulp of the twin's at fb = 192."""
    mlp = _on(cuda, _layer(D, seed=8)[1])
    x = torch.randn(1, 8, D, generator=torch.Generator().manual_seed(8)).to(cuda, torch.bfloat16)
    fbq.reset_launches()
    got = fbq.mlp_block_q(x, *mlp, fb=192, w1_qt=mlp[2].t().contiguous(),
                          w2_qt=mlp[5].t().contiguous())
    assert fbq.KB_LAUNCHES["mlp_block_q_fsplit"] == 1
    within_one_ulp(got.cpu(), fbq.mlp_block_q_plain(x, *mlp, fb=192).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(4, S), (2, 77), (2, 400)])
def test_cuda_opt_matches_twin(cuda, b, s):
    ls, lb, wqkv, bqkv, wo, bo = _on(cuda, _bf16_block(D, seed=6))
    wq, bq = fb.prescale_qkv(wqkv, bqkv, D, H)
    x = torch.from_numpy(_x(b, s, D, seed=s)).to(cuda, torch.bfloat16)
    fb.reset_launches()
    got = fb.attention_block_opt(x, ls, lb, wq, bq, wo, bo, heads=H)
    torch.cuda.synchronize()
    assert fb.KB_LAUNCHES["attention_block_opt"] == 1
    assert fb.CORE_ROUTES[fb.core_route(s)] == 1
    within_one_ulp(got.cpu(), fb.attention_block_opt_plain(x, ls, lb, wq, bq, wo, bo,
                                                           heads=H).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(4, S), (3, 50)])
def test_cuda_layer_matches_twin(cuda, b, s):
    attn, mlp = (_on(cuda, h) for h in _layer(D, seed=9))
    kw = {"wqkv_qt": attn[2].t().contiguous(), "wo_qt": attn[5].t().contiguous(),
          "w1_qt": mlp[2].t().contiguous(), "w2_qt": mlp[5].t().contiguous()}
    x = torch.from_numpy(_x(b, s, D, seed=s)).to(cuda, torch.bfloat16)
    fbq.reset_launches()
    sk = {}
    got = fbq.fused_layer_q(x, *attn, *mlp, heads=H, **kw, scratch=sk)
    torch.cuda.synchronize()
    assert fbq.KB_LAUNCHES["fused_layer_q"] == 1
    # the layer normalises and quantizes in one pass and writes no LayerNorm
    # rows: its codes are held to K3's and K4's LayerNorm rows of x and bf16(y)
    s3, s4 = {}, {}
    fbq.attention_block_q(x, *attn, heads=H, wqkv_qt=kw["wqkv_qt"], wo_qt=kw["wo_qt"],
                          scratch=s3)
    fbq.mlp_block_q(sk["y"].to(torch.bfloat16), *mlp, w1_qt=kw["w1_qt"], w2_qt=kw["w2_qt"],
                    scratch=s4)
    sk.update(xn=s3["xn"], yn=s4["xn"])
    _codes_are_own(sk, [("xq", "xn", "xs"), ("aq", "attn", "as"), ("yq", "yn", "ys"),
                        ("hq", "h", "hs")])
    y = x.float() + (fbq.dot_q(sk["aq"], sk["as"], attn[5], attn[6]) + attn[7])
    torch.testing.assert_close(sk["y"], y, atol=0, rtol=0)
    own = ((sk["y"] + mlp[7]) + fbq.dot_q(sk["hq"], sk["hs"], mlp[5], mlp[6]))
    within_one_ulp(got.cpu(), own.to(torch.bfloat16).cpu())
    within_one_ulp(got.cpu(), fbq.fused_layer_q_plain(x, *attn, *mlp, heads=H).cpu())
