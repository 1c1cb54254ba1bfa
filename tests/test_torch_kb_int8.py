"""KB (a) 1-4, the int8 kernel experiments of ``benchmarks/``, in the PyTorch
port (debias_vision_lang_torch/ops/fused_block_q.py) against their Pallas
bodies.

  * (a) 1, ``attention_block_qq`` (benchmarks/attn_int8_cores.py): loaded
    from its file with ``pl.pallas_call`` patched to ``interpret=True`` on
    the module object (restored by monkeypatch), at B=3 S=13 D=32 H=2 (both
    chain widths bb) and B=2 S=50 D=64 H=1: float32 at atol 1e-4 (the bar
    of tests/test_torch_fused_block.py::TestQTwinsAgainstPallas), bfloat16
    within one bf16 ulp of the output's largest magnitude; and at ViT-B/16's
    full width (B=1 S=197 D=768 H=12) at the full-width bars below.
  * (a) 2-4: their kernel bodies are closures inside ``main()`` of
    benchmarks/q_mlp_bf16h.py and benchmarks/q_kernel_variants.py.  A
    module-scoped fixture runs both ``main()`` once (VAR_BATCH / ILP_BATCH
    12, VAR_STEPS / ILP_STEPS 1) with ``jax.experimental.pallas.pallas_call``
    replaced by a recorder that keeps each kernel partial by its function's
    name and returns zeros of ``out_shape``; the captured ``pipe_kernel``
    (bb=1, depth=2, bf16h True and False), ``mlp_q_kernel_var`` (both
    ``bf16_gelu``) and ``attn_q_kernel_var`` (both ``packed``) then run
    through the real ``pallas_call`` with ``interpret=True`` on 2 batch
    items at the closures' own width (S=197, D=768, H=12, F=3072).
  * Full-width bars.  bfloat16: within one bf16 ulp of the output's largest
    magnitude.  float32: atol 1e-4 on every row but at most 5% of them,
    which stay within one bf16 ulp of the largest magnitude.  At 768 to
    3,072 values a row, a last-bit difference between XLA's fused CPU code
    and torch's (LayerNorm's mean and variance, the softmax's row sum, exp,
    sigmoid) lands on an int8 rounding boundary now and then and flips a
    code, which moves its row by up to one code step (up to 1.6e-3 here;
    K4's own twin sits 1e-2 from JAX's K4 on some rows at this width); the
    float32 bar of the small widths holds wherever no code flips.
  * XLA's rounding of the bf16 chains (the twins compute what the JAX
    bodies compute on the CPU): the bf16 quick_gelu of
    ``mlp_q_kernel_var`` rounds its product, exp and sum to bf16 and keeps
    the division in f32 (the excess-precision rewrite drops the rounding
    before the f32 convert), held bit for bit; ``pipe_kernel``'s bf16
    hidden is rounded.
  * ``quant_rows_recip`` against ``_quant_rows_recip``'s text in jnp, bit
    for bit; the launch counters; the refusals of the int8 core; the
    sources (the int8 core's products in csrc/attention_qq.cuh, the build
    digest following it).
  * CUDA (marker ``cuda``, skipped without a card): each kernel against its
    twin at full width and at every key bucket of the int8 core.

jax is imported inside the JAX-side helpers only (``tests/kb_helpers.py``
holds the recorder, the script loader and the interpret-mode runner), so
the CUDA tests run on a machine without jax:  python -m pytest
tests/test_torch_kb_int8.py -m cuda --noconftest -p no:randomly
"""

import functools
import pathlib

import numpy as np
import pytest
import torch

from debias_vision_lang_torch.ops import _build
from debias_vision_lang_torch.ops import fused_block as fb
from debias_vision_lang_torch.ops import fused_block_q as fbq
from kb_helpers import _jnp, _layer, _np32, _pallas_ops, _t, _ulp, _x, capture, check
from kb_helpers import interpret as _interpret
from kb_helpers import load as _load
from kb_helpers import within_one_ulp

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
CSRC = REPO / "debias_vision_lang_torch" / "csrc"
S, D, H, F = 197, 768, 12, 3072  # ViT-B/16: the closures' width


# ---------------------------------------------------------------------------
# The captured closures of q_kernel_variants.py and q_mlp_bf16h.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def captured():
    return capture(("q_kernel_variants", "q_mlp_bf16h"),
                   {"VAR_BATCH": 12, "ILP_BATCH": 12, "VAR_STEPS": 1, "ILP_STEPS": 1})


@pytest.fixture(scope="module")
def full_block():
    return _layer(D, seed=5)


def test_recorder_ran_every_body(captured):
    """Each ``main()`` went through the recorder for every kernel it calls:
    the three variant bodies (with the arguments their scripts give them)
    and the production K3 / K4 baselines."""
    assert {"mlp_q_kernel_var", "attn_q_kernel_var", "pipe_kernel", "_mlp_q_pipe_kernel",
            "_attn_q_chains_kernel"} <= set(captured)
    assert [k.keywords for k in captured["mlp_q_kernel_var"]] == [{"bf16_gelu": False},
                                                                 {"bf16_gelu": True}]
    assert [k.keywords for k in captured["attn_q_kernel_var"]] == [{"packed": False},
                                                                  {"packed": True}]
    assert [k.keywords for k in captured["pipe_kernel"]] == [
        {"bb": 4, "depth": 2, "bf16h": True}, {"bb": 6, "depth": 2, "bf16h": True},
        {"bb": 4, "depth": 3, "bf16h": True}]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bf16_gelu", [False, True])
def test_mlp_var_matches_the_pallas_body(captured, full_block, bf16_gelu, dtype):
    import jax.numpy as jnp

    mlp = full_block[1]
    kern = next(k for k in captured["mlp_q_kernel_var"] if k.keywords["bf16_gelu"] == bf16_gelu)
    x = _x(2, S, D)
    ref = _interpret(kern, _jnp(x, getattr(jnp, dtype)), _pallas_ops(mlp))
    got = fbq.mlp_block_q_var(_t(x, getattr(torch, dtype)), *map(_t, mlp), bf16_gelu=bf16_gelu)
    check(got, ref, dtype, full_width=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bf16h", [True, False])
def test_pipe_kernel_matches_the_twin(captured, full_block, bf16h, dtype):
    """``pipe_kernel`` at bb=1, depth=2: bf16h is KB (a) 2's twin; without
    it the body is K4's function (K4's twin)."""
    import jax.numpy as jnp

    mlp = full_block[1]
    base = captured["pipe_kernel"][0]
    kern = functools.partial(base.func, bb=1, depth=2, bf16h=bf16h)
    x = _x(2, S, D, seed=2)
    ref = _interpret(kern, _jnp(x, getattr(jnp, dtype)), _pallas_ops(mlp))
    twin = fbq.mlp_block_q_bf16h if bf16h else fbq.mlp_block_q
    got = twin(_t(x, getattr(torch, dtype)), *map(_t, mlp))
    check(got, ref, dtype, full_width=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("packed", [False, True])
def test_attn_var_matches_the_pallas_body(captured, full_block, packed, dtype):
    """Both packings against the one twin: the head pairs' block-diagonal Q
    regroups the same products (zeros added) and the same exp2."""
    import jax.numpy as jnp

    attn = full_block[0]
    kern = next(k for k in captured["attn_q_kernel_var"] if k.keywords["packed"] == packed)
    ls, lb, wq, ws, bq, woq, wos, bo = attn
    ops = tuple(map(_jnp, (ls[None], lb[None], wq, ws.reshape(1, -1), bq[None], woq,
                           wos.reshape(1, -1), bo[None])))
    x = _x(2, S, D, seed=3)
    ref = _interpret(kern, _jnp(x, getattr(jnp, dtype)), ops)
    got = fbq.attention_block_q_var(_t(x, getattr(torch, dtype)), *map(_t, attn), heads=H)
    check(got, ref, dtype, full_width=True)


def test_bf16_quick_gelu_is_xlas_bit_for_bit():
    """``mlp_q_kernel_var``'s bf16 quick_gelu expression in a Pallas body
    (interpret mode) against ``quick_gelu_bf16``: equal bits.  XLA rounds
    the product, the exp and the sum to bf16 and keeps the division f32;
    rounding the division too, or nothing, differs on most elements."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    def body(h_ref, o_ref):
        hb = h_ref[:].astype(jnp.bfloat16)
        c = jnp.asarray(-1.702, jnp.bfloat16)
        one = jnp.asarray(1.0, jnp.bfloat16)
        o_ref[:] = (hb / (one + jnp.exp(c * hb))).astype(jnp.float32)

    h = (np.random.default_rng(4).normal(size=(64, 1024)) * 3).astype(np.float32)
    want = np.asarray(pl.pallas_call(body, out_shape=jax.ShapeDtypeStruct(h.shape, jnp.float32),
                                     interpret=True)(h))
    got = fbq.quick_gelu_bf16(torch.from_numpy(h)).numpy()
    np.testing.assert_array_equal(got, want)
    rounded = fbq.quick_gelu_bf16(torch.from_numpy(h)).to(torch.bfloat16).float().numpy()
    assert (rounded != want).mean() > 0.5


def test_pipe_kernel_rounds_its_hidden_to_bf16():
    """``pipe_kernel``'s ``h.astype(bf16)`` then ``.astype(f32)`` survives
    XLA: the same pattern in a Pallas body equals the twin's rounded
    hidden through quick_gelu, not the unrounded one."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    def body(h_ref, o_ref):
        g = (h_ref[:] + 0.5).astype(jnp.bfloat16).astype(jnp.float32)
        o_ref[:] = g * jax.nn.sigmoid(1.702 * g)

    h = (np.random.default_rng(5).normal(size=(64, 1024)) * 3).astype(np.float32)
    want = np.asarray(pl.pallas_call(body, out_shape=jax.ShapeDtypeStruct(h.shape, jnp.float32),
                                     interpret=True)(h))
    t = torch.from_numpy(h) + 0.5
    g = t.to(torch.bfloat16).float()
    np.testing.assert_allclose(_np32(g * torch.sigmoid(1.702 * g)), want, rtol=0, atol=1e-6)
    assert np.abs(_np32(t * torch.sigmoid(1.702 * t)) - want).max() > 1e-3


def test_quant_rows_recip_matches_its_jax_text():
    """``_quant_rows_recip`` is a closure of q_kernel_variants.py's main():
    its text in jnp, op by op (as TestQTwinsAgainstPallas holds quant_rows:
    jitted, XLA may multiply by 1/127 where the text divides), against the
    twin, bit for bit (a zero row, and exact halves at scale 1); codes may
    differ from the division's, by one."""
    import jax.numpy as jnp

    def recip(x_f32):
        amax = jnp.max(jnp.abs(x_f32), axis=-1, keepdims=True)
        scale = jnp.maximum(amax / 127.0, 1e-8)
        inv = 1.0 / scale
        return jnp.clip(jnp.round(x_f32 * inv), -127, 127).astype(jnp.int8), scale

    x = np.random.default_rng(6).normal(size=(64, 7, 768)).astype(np.float32)
    x[0, 0] = 0.0
    x[1, 1, :4] = [127.0, 2.5, -3.5, 0.5]
    want_q, want_s = recip(_jnp(x))
    got_q, got_s = fbq.quant_rows_recip(torch.from_numpy(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_q[1, 1, :4].tolist() == [127, 2, -4, 0]
    div_q, div_s = fbq.quant_rows(torch.from_numpy(x))
    assert torch.equal(div_s, got_s)
    assert (div_q.int() - got_q.int()).abs().max() <= 1


# ---------------------------------------------------------------------------
# (a) 1: attention_block_qq from its module, in interpret mode
# ---------------------------------------------------------------------------


@pytest.fixture
def int8_cores(monkeypatch):
    """benchmarks/attn_int8_cores.py with its pallas_call in interpret mode."""
    mod = _load("attn_int8_cores")
    monkeypatch.setattr(mod.pl, "pallas_call",
                        functools.partial(mod.pl.pallas_call, interpret=True))
    return mod


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,d,heads,bb", [(3, 13, 32, 2, 1), (3, 13, 32, 2, 3),
                                            (2, 50, 64, 1, 1)])
def test_qq_matches_the_pallas_kernel(int8_cores, b, s, d, heads, bb, dtype):
    import jax.numpy as jnp

    attn, _ = _layer(d)
    x = _x(b, s, d)
    ref = int8_cores.attention_block_qq(_jnp(x, getattr(jnp, dtype)), *map(_jnp, attn),
                                        heads=heads, bb=bb)
    got = fbq.attention_block_qq(_t(x, getattr(torch, dtype)), *map(_t, attn), heads=heads)
    check(got, ref, dtype, full_width=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qq_matches_the_pallas_kernel_at_full_width(int8_cores, full_block, dtype):
    import jax.numpy as jnp

    x = _x(1, S, D, seed=7)
    ref = int8_cores.attention_block_qq(_jnp(x, getattr(jnp, dtype)),
                                        *map(_jnp, full_block[0]), heads=H)
    got = fbq.attention_block_qq(_t(x, getattr(torch, dtype)), *map(_t, full_block[0]),
                                 heads=H)
    check(got, ref, dtype, full_width=True)


def test_qq_core_scratch_is_its_own_quantization():
    """The core's scratch: p rows sum to 1, the codes are quant_rows of p,
    and the output is (int32 p v * p scale) * v scale on those codes."""
    qkv = torch.from_numpy(_x(2, 13, 3 * 64, seed=8))
    scratch = {}
    out = fbq.attention_qq_core(qkv, 1, torch.float32, scratch=scratch)
    p, pq, psc = scratch["p"], scratch["pq"], scratch["psc"]
    assert p.shape == pq.shape == (2, 1, 13, 13) and psc.shape == (2, 1, 13, 1)
    torch.testing.assert_close(p.sum(-1), torch.ones(2, 1, 13), atol=1e-6, rtol=0)
    q, s = fbq.quant_rows(p)
    assert torch.equal(q, pq) and torch.equal(s, psc)
    vq, vsc = fbq.quant_rows(qkv[..., 128:].transpose(1, 2))
    o = (pq[:, 0].double() @ vq.transpose(1, 2).double()).float() * psc[:, 0] * vsc.transpose(1, 2)
    assert torch.equal(out, o)


def test_qq_block_scratch_keeps_qkv_f32():
    attn, _ = _layer(32)
    scratch = {}
    fbq.attention_block_qq(_t(_x(2, 9, 32), torch.bfloat16), *map(_t, attn), heads=2,
                           scratch=scratch)
    assert scratch["qkv"].dtype == torch.float32
    q, s = fbq.quant_rows(scratch["attn"])
    assert torch.equal(q, scratch["aq"]) and torch.equal(s, scratch["as"])


# ---------------------------------------------------------------------------
# Counters, refusals and sources
# ---------------------------------------------------------------------------


def test_cpu_twins_do_not_count():
    attn, mlp = _layer(32)
    x = _t(_x(2, 9, 32), torch.bfloat16)
    fbq.reset_launches()
    fbq.attention_block_qq(x, *map(_t, attn), heads=2)
    fbq.attention_block_q_var(x, *map(_t, attn), heads=2)
    fbq.mlp_block_q_bf16h(x, *map(_t, mlp))
    for bf16_gelu in (False, True):
        fbq.mlp_block_q_var(x, *map(_t, mlp), bf16_gelu=bf16_gelu)
    assert fbq.KB_LAUNCHES == dict.fromkeys(fbq.KB_LAUNCHES, 0)
    assert sum(fbq.LAUNCHES.values()) == 0


def test_reset_clears_the_kb_counters():
    fbq.KB_LAUNCHES["attention_block_qq"] = 3
    fbq.reset_launches()
    assert set(fbq.KB_LAUNCHES.values()) == {0}


@pytest.mark.parametrize("s,d,heads,route", [
    (257, 768, 12, "tiled"), (197, 768, 6, "tiled"), (197, 384, 12, "register"),
    (256, 768, 12, "register")])
def test_qq_core_refusals(int8_cores, s, d, heads, route):
    """The shapes the card's int8 core once refused (past 256 keys, head
    dims 128 and 32) now compute JAX's function: the block around the core
    against attention_block_qq in interpret mode at bfloat16 (the full-width
    bar: one bf16 ulp); the core's twin on the card's layout (each head
    zero-padded to a multiple of 64 lanes: ``attn_plan``) gives the unpadded
    core's output bit for bit, and the card's route (``qq_route``) is the
    tiled one past 256 keys or past head dim 64 (32 pads to the register
    route's 64)."""
    import jax.numpy as jnp

    assert fbq.qq_route(s, d // heads) == route
    attn, _ = _layer(d, seed=s + heads)
    x = _x(1, s, d, seed=heads)
    ref = int8_cores.attention_block_qq(_jnp(x, jnp.bfloat16), *map(_jnp, attn), heads=heads)
    got = fbq.attention_block_qq(_t(x, torch.bfloat16), *map(_t, attn), heads=heads)
    check(got, ref, "bfloat16", full_width=True)
    qkv = torch.from_numpy(_x(1, s, 3 * d, seed=7))
    plan = fb.attn_plan(d, heads)
    padded = fb.place(qkv[0], (s, 3 * plan.da), cols=plan.qkv_columns())[None]
    want = fbq.attention_qq_core_plain(qkv, heads, torch.bfloat16)
    pad = fbq.attention_qq_core_plain(padded, heads, torch.bfloat16, scale=plan.scale)
    assert torch.equal(plan.crop_heads(pad), want)


def test_qq_block_refuses_past_256_keys(int8_cores, full_block):
    """KB (a) 1 past 256 keys (the card's tiled route) at ViT-B/16's width,
    bfloat16: within one bf16 ulp of attention_block_qq in interpret mode."""
    import jax.numpy as jnp

    x = _x(1, 257, D, seed=11)
    ref = int8_cores.attention_block_qq(_jnp(x, jnp.bfloat16), *map(_jnp, full_block[0]),
                                        heads=H)
    got = fbq.attention_block_qq(_t(x, torch.bfloat16), *map(_t, full_block[0]), heads=H)
    check(got, ref, "bfloat16", full_width=True)
    assert fbq.qq_route(257, 64) == "tiled"


def test_qq_core_products_are_int8_mma_in_the_header():
    """Both products of the int8 core are s8 wgmma (SS for Q K^T at a key
    tile and at each register-route bucket, RS for P V at each output
    width), fed by TMA; no mma.sync is left in its header."""
    src = (CSRC / "attention_qq.cuh").read_text()
    assert "mma.sync" not in src
    assert "wgmma_ss_s8<N>(" in src and "wgmma_ss_s8<64>(" in src
    assert "wgmma_rs_s8<64>(" in src and "wgmma_rs_s8<NO>(" in src
    assert "tma_load_3d(" in src and "CU_TENSOR_MAP_SWIZZLE_64B" in src
    hopper = (CSRC / "hopper.cuh").read_text()
    for n in (64, 128, 224, 256):
        assert (f"wgmma_ss_s8<{n}>(" in hopper
                and (n == 128 or f"wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 {{" in hopper))
    for n in (64, 128, 192, 256):
        assert f"wgmma_rs_s8<{n}>(" in hopper
        assert f"wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 {{" in hopper
    cu = (CSRC / "fused_block_q.cu").read_text()
    assert '#include "attention_qq.cuh"' in cu
    impl = cu[cu.index("int attention_block_q_impl("):cu.index("int mlp_block_q_impl(")]
    assert impl.count("launch_attention_qq(") == 1
    assert impl.count("launch_gemm_s8<EQ_BIAS_F32>(") == 1
    py = pathlib.Path(fbq.__file__).read_text()
    core = py[py.index("def _attention_qq_core_cuda("):py.index("# K4 and its KB variants")]
    assert "int_mm" not in core and "scaled_dot_product" not in core


def _qq_sass(body):
    names = [f"_ZN12_GLOBAL__N_119attention_qq_kernelILi{n}EEEv14CUtensorMap_st" for n in
             (64, 128, 224, 256)]
    names += [f"_ZN12_GLOBAL__N_125attention_qq_tiled_kernelILi{n}EEEv14CUtensorMap_st" for n in
              (64, 128, 192, 256)]
    return {name: body for name in names}


def _rows_strip_sass(body):
    """rows_q_partial's row-strip kernel, rows_strip_q_kernel<T, KB>: bf16
    and f32 inputs, one to three K steps."""
    return {f"_ZN12_GLOBAL__N_119rows_strip_q_kernelI{t}Li{kb}EEEvPKT_6TpPtrsi": body
            for t in ("13__nv_bfloat16", "f") for kb in (1, 2, 3)}


@pytest.mark.parametrize("broken", [None, "no IGMMA", "no UTMALDG", "missing"])
def test_sass_check_holds_every_qq_instantiation_to_wgmma_and_tma(monkeypatch, broken):
    """chip_smoke.sass_check_per_kernel: each of the int8 core's eight
    instantiations (four key buckets, four output widths) must hold s8 wgmma
    (IGMMA) and TMA loads (UTMALDG); a missing instantiation or form fails."""
    import sys

    sys.path.insert(0, str(REPO))
    import chip_smoke as C

    funcs = _qq_sass("IGMMA.64x64x32.S32.S8.S8 ; UTMALDG.3D ;")
    name = next(iter(funcs))
    funcs["_ZN12_GLOBAL__N_118qq_quant_qk_kernelEPKf"] = "LDG.E.128 ;"
    funcs.update(_rows_strip_sass("IGMMA.64x128x32.S32.S8.S8 ; UTMALDG.2D ;"))
    if broken == "no IGMMA":
        funcs[name] = "UTMALDG.3D ;"
    elif broken == "no UTMALDG":
        funcs[name] = "IGMMA.64x64x32.S32.S8.S8 ;"
    elif broken == "missing":
        del funcs[name]
    monkeypatch.setattr(C, "sass_functions", lambda path: dict(funcs))
    assert C.SASS_PER_KERNEL["fused_block_q"][0][:2] == ("attention_qq_", ("IGMMA", "UTMALDG"))
    if broken is None:
        C.sass_check_per_kernel("fused_block_q", "lib.so")
    else:
        with pytest.raises(RuntimeError):
            C.sass_check_per_kernel("fused_block_q", "lib.so")


@pytest.mark.parametrize("entry", ["dvl_attention_block_qq", "dvl_attention_block_q_var",
                                   "dvl_attention_qq_core", "dvl_mlp_block_q_kb"])
def test_the_library_exports_each_entry(entry):
    assert f"int {entry}(" in (CSRC / "fused_block_q.cu").read_text()


def test_build_digest_follows_the_int8_core(tmp_path):
    for f in CSRC.glob("*.cu*"):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    flags = _build.nvcc_flags(tmp_path)
    before = _build.source_digest(tmp_path, "fused_block_q", flags)
    (tmp_path / "attention_qq.cuh").write_text(
        (tmp_path / "attention_qq.cuh").read_text() + "\n// edited\n")
    assert _build.source_digest(tmp_path, "fused_block_q", flags) != before


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


def _cuda_block(d, dev, seed=3):
    """(attention args, kwargs), (MLP args, kwargs) on the card, with the
    kernels' transposed weight copies."""
    attn, mlp = _layer(d, seed)
    a = [_t(v).to(dev) for v in attn]
    m = [_t(v).to(dev) for v in mlp]
    return ((a, {"wqkv_qt": a[2].t().contiguous(), "wo_qt": a[5].t().contiguous()}),
            (m, {"w1_qt": m[2].t().contiguous(), "w2_qt": m[5].t().contiguous()}))


def _codes_are_own(scratch, quantizer, pairs):
    for codes, rows, scales in pairs:
        q, s = quantizer(scratch[rows])
        assert torch.equal(q, scratch[codes]) and torch.equal(s, scratch[scales]), codes


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(4, 197), (3, 50), (2, 77), (2, 128), (2, 256), (32, 785)])
def test_cuda_qq_block_matches_twin(cuda, b, s):
    (a, akw), _ = _cuda_block(D, cuda)
    x = torch.from_numpy(_x(b, s, D, seed=s)).to(cuda, torch.bfloat16)
    fbq.reset_launches()
    sk = {}
    got = fbq.attention_block_qq(x, *a, heads=H, **akw, scratch=sk)
    torch.cuda.synchronize()
    assert fbq.KB_LAUNCHES["attention_block_qq"] == 1
    _codes_are_own(sk, fbq.quant_rows, [("xq", "xn", "xs"), ("aq", "attn", "as")])
    within_one_ulp(got.cpu(), fbq.attention_block_qq_plain(x, *a, heads=H).cpu())
    # the core on the kernel's own f32 qkv
    core = fbq.attention_qq_core_plain(sk["qkv"], H, torch.bfloat16).float()
    within_one_ulp(sk["attn"].cpu(), core.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 33, 64, 65, 128, 129, 197, 224, 225, 256])
def test_cuda_qq_core_every_key_bucket(cuda, s):
    """The int8 core alone at both sides of each bucket (64, 128, 224, 256
    keys): its p codes are quant_rows of its own p, and its output is the
    twin's P V on those codes."""
    qkv = torch.from_numpy(_x(2, s, 3 * D, seed=s)).to(cuda)
    sk, sr = {}, {}
    got = fbq.attention_qq_core(qkv, H, scratch=sk)
    ref = fbq.attention_qq_core_plain(qkv, H, torch.bfloat16, scratch=sr)
    torch.cuda.synchronize()
    assert torch.equal(fbq.quant_rows(sk["p"])[0], sk["pq"])
    torch.testing.assert_close(sk["p"], sr["p"], atol=1e-6, rtol=0)
    vq, vsc = fbq.quant_rows(qkv[..., 2 * D:].reshape(2, s, H, 64).permute(0, 2, 3, 1))
    own = (sk["pq"].double() @ vq.transpose(-1, -2).double()).float() * sk["psc"] \
        * vsc.transpose(-1, -2)
    own = own.to(torch.bfloat16).permute(0, 2, 1, 3).reshape(2, s, D)
    assert torch.equal(got, own)
    flipped = (sk["pq"] != sr["pq"]).sum().item()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= _ulp(ref.float().cpu().numpy()) or flipped > 0


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(32, 785), (256, 197)])
def test_cuda_qq_core_at_the_timed_shapes(cuda, b, s):
    """The int8 core at the shapes its routes are timed at (the int8 joint
    Frozen-in-Time attention, B=32 S=785 H=12, tiled; ViT-B/16 at B=256,
    register): p's codes its own p's quant_rows, the output the exact P V
    on them, p within 1e-6 of the twin's, every output past one bf16 ulp on
    a row with a flipped p code; the workspace the size of its layout."""
    qkv = torch.from_numpy(_x(b, s, 3 * D, seed=b + s)).to(cuda)
    sk, sr = {}, {}
    fbq.reset_launches()
    got = fbq.attention_qq_core(qkv, H, scratch=sk)
    torch.cuda.synchronize()
    assert fbq.QQ_ROUTES[fbq.qq_route(s, 64)] == 1 and fbq.KB_LAUNCHES["attention_qq_core"] == 1
    sp = -(-s // 64) * 64
    assert fbq._lib().dvl_qq_ws_bytes(b, s, H, 64) == 3 * b * H * sp * 64 + 2 * b * H * sp * 4 \
        + -(-b * H * 64 * 4 // 256) * 256
    assert torch.equal(fbq.quant_rows(sk["p"])[0], sk["pq"])
    assert torch.equal(fbq.quant_rows(sk["p"])[1], sk["psc"])
    vq, vsc = fbq.quant_rows(qkv[..., 2 * D:].reshape(b, s, H, 64).permute(0, 2, 3, 1))
    own = (sk["pq"].double() @ vq.transpose(-1, -2).double()).float() * sk["psc"] \
        * vsc.transpose(-1, -2)
    assert torch.equal(got, own.to(torch.bfloat16).permute(0, 2, 1, 3).reshape(b, s, D))
    del own, vq
    ref = fbq.attention_qq_core_plain(qkv, H, torch.bfloat16, scratch=sr)
    assert (sk["p"] - sr["p"]).abs().max().item() <= 1e-6
    flipped = (sk["pq"] != sr["pq"]).any(-1).permute(0, 2, 1)  # [B, S, H]
    past = ((got.float() - ref.float()).abs() > _ulp(ref.float().cpu().numpy()))
    assert not (past.reshape(b, s, H, 64).any(-1) & ~flipped).any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["var", "bf16h", "var_bf16_gelu", "attn_var"])
@pytest.mark.parametrize("b,s", [(4, 197), (3, 77)])
def test_cuda_variants_match_twins(cuda, kind, b, s):
    (a, akw), (m, mkw) = _cuda_block(D, cuda, seed=4)
    x = torch.from_numpy(_x(b, s, D, seed=9)).to(cuda, torch.bfloat16)
    sk = {}
    fbq.reset_launches()
    if kind == "attn_var":
        got = fbq.attention_block_q_var(x, *a, heads=H, **akw, scratch=sk)
        ref = fbq.attention_block_q_var_plain(x, *a, heads=H)
        _codes_are_own(sk, fbq.quant_rows_recip, [("xq", "xn", "xs"), ("aq", "attn", "as")])
        key = "attention_block_q_var"
    elif kind == "bf16h":
        got = fbq.mlp_block_q_bf16h(x, *m, **mkw, scratch=sk)
        ref = fbq.mlp_block_q_bf16h_plain(x, *m)
        s4 = {}  # one LayerNorm-and-quantize pass: K4's LayerNorm rows of the same x
        fbq.mlp_block_q(x, *m, **mkw, scratch=s4)
        sk["xn"] = s4["xn"]
        _codes_are_own(sk, fbq.quant_rows, [("xq", "xn", "xs"), ("hq", "h", "hs")])
        key = "mlp_block_q_bf16h"
    else:
        bf16_gelu = kind == "var_bf16_gelu"
        got = fbq.mlp_block_q_var(x, *m, bf16_gelu=bf16_gelu, **mkw, scratch=sk)
        ref = fbq.mlp_block_q_var_plain(x, *m, bf16_gelu=bf16_gelu)
        s4 = {}  # one LayerNorm-and-quantize pass: K4's LayerNorm rows of the same x
        fbq.mlp_block_q(x, *m, **mkw, scratch=s4)
        sk["xn"] = s4["xn"]
        _codes_are_own(sk, fbq.quant_rows_recip, [("xq", "xn", "xs"), ("hq", "h", "hs")])
        key = "mlp_block_q_" + kind
    torch.cuda.synchronize()
    assert fbq.KB_LAUNCHES[key] == 1
    within_one_ulp(got.cpu(), ref.cpu())


@pytest.mark.cuda
def test_cuda_attn_var_on_the_long_core(cuda):
    """Past 320 keys the variant's core runs the long route, dividing by
    the row sum there too."""
    (a, akw), _ = _cuda_block(D, cuda, seed=6)
    x = torch.from_numpy(_x(2, 400, D, seed=10)).to(cuda, torch.bfloat16)
    got = fbq.attention_block_q_var(x, *a, heads=H, **akw)
    torch.cuda.synchronize()
    within_one_ulp(got.cpu(), fbq.attention_block_q_var_plain(x, *a, heads=H).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("s,hd", [(257, 64), (400, 64), (785, 64), (77, 80), (257, 80),
                                  (197, 128), (1100, 64), (65, 192), (257, 256), (77, 800),
                                  (1, 800)])
def test_cuda_qq_takes_every_key_count_and_head_dim(cuda, s, hd):
    """The int8 core's tiled route (past 256 keys, or off head dim 64): its
    p codes are quant_rows of its own p, its output is the exact int32 P V
    on those codes (one f32 conversion: S * 127^2 passes 2^24 at 1,100
    keys), its p within 1e-6 of the twin's; the block within one bf16 ulp
    of its twin, and its core within one ulp of the twin's core on the
    kernel's own f32 qkv.  A float32 output is refused."""
    h = 2
    d = h * hd
    qkv = torch.from_numpy(_x(2, s, 3 * d, seed=s + hd)).to(cuda)
    sk, sr = {}, {}
    fbq.reset_launches()
    got = fbq.attention_qq_core(qkv, h, scratch=sk)
    ref = fbq.attention_qq_core_plain(qkv, h, torch.bfloat16, scratch=sr)
    torch.cuda.synchronize()
    assert fbq.QQ_ROUTES == {"register": 0, "tiled": 1}
    assert torch.equal(fbq.quant_rows(sk["p"])[0], sk["pq"])
    torch.testing.assert_close(sk["p"], sr["p"], atol=1e-6, rtol=0)
    vq, vsc = fbq.quant_rows(qkv[..., 2 * d:].reshape(2, s, h, hd).permute(0, 2, 3, 1))
    own = (sk["pq"].double() @ vq.transpose(-1, -2).double()).float() * sk["psc"] \
        * vsc.transpose(-1, -2)
    own = own.to(torch.bfloat16).permute(0, 2, 1, 3).reshape(2, s, d)
    assert torch.equal(got, own)
    (a, akw), _ = _cuda_block(d, cuda, seed=hd)
    x = torch.from_numpy(_x(2, s, d, seed=4)).to(cuda, torch.bfloat16)
    sk = {}
    blk = fbq.attention_block_qq(x, *a, heads=h, **akw, scratch=sk)
    torch.cuda.synchronize()
    _codes_are_own(sk, fbq.quant_rows, [("xq", "xn", "xs"), ("aq", "attn", "as")])
    within_one_ulp(blk.cpu(), fbq.attention_block_qq_plain(x, *a, heads=h).cpu())
    core = fbq.attention_qq_core_plain(sk["qkv"], h, torch.bfloat16).float()
    within_one_ulp(sk["attn"].cpu(), core.cpu())
    with pytest.raises(TypeError, match="bfloat16"):
        fbq.attention_qq_core(torch.zeros(1, 8, 3 * D, device=cuda), H, torch.float32)
