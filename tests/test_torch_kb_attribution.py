"""The two kernel sites of ``benchmarks/q_attribution.py`` (KB (c)) in the
PyTorch port (``fused_block_q.mlp_block_q_attr`` / ``attention_block_q_attr``
and their twins) against their Pallas bodies.

``mlp_kernel`` (``make_mlp(mode)``, :106) and ``attn_kernel``
(``make_attn(mode)``, :196) are partials inside the script's ``main()``:
captured by ``kb_helpers.capture`` (ATTR_BATCH 1, ATTR_STEPS 1; three per
body, picked by their ``mode`` keyword) and run through the real
``pallas_call`` in interpret mode, one image a grid step, on 2 images at
the bodies' own width, ViT-B/16 (S=197, D=768, H=12, F=3072), on the
script's inputs (N(0, 0.25) in bf16) and a block of ``kb_helpers._layer``.

Bars:
  * "full" is K3 / K4: the attention body bit for bit equal to JAX's own
    ``attention_block_q`` in interpret mode (bb=1); the MLP body within one
    bf16 ulp of JAX's ``mlp_block_q`` (bb=1, unsplit) and equal to it on all
    but 1e-3 of the outputs (K4 keeps x + b2 + part in an f32 scratch under
    ``pl.when``, and XLA's CPU code rounds 14 of the 302,592 outputs here
    otherwise than the body's single expression); the port's entry within
    one bf16 ulp of the body's largest magnitude.
  * "mxu" and "vpu": the body's int8 codes are recorded by running the
    body itself under ``jax.jit`` with its ``_dot_q`` and ``_quant_rows``
    wrapped (that run's output is checked bit-equal to interpret mode's),
    and held to the twin's: equal for "mxu" (the static cast, exact int32
    products, the f32 epilogue and the truncating cast agree bit for bit at
    these inputs); for "vpu" at most 1e-3 of them differ, by at most 1 (XLA's
    fused LayerNorm rounds a few normalised values otherwise than torch's:
    about 1 x code in 10^4 moves, and with it the row's hidden codes now and
    then).  The output within one bf16 ulp of the body's largest magnitude on
    every row whose codes all agree, and everywhere.
  * ``to_s8_sat`` equal to ``astype(jnp.int8)`` (XLA's conversion: toward
    zero, saturated, NaN to 0) on the edge values, +-inf and NaN, and on a
    float32 and a bfloat16 sweep.
  * CUDA (marker ``cuda``, skipped without a card): each new kernel against
    its twin: its codes the twin's conversion of its own rows, exactly, and
    off the twin's in at most 1e-3 of them, by at most 1 (the "mxu" core
    sums Q K^T and P V in another order than the twin, and the truncating
    cast moves a code where an attention value's bf16 rounding lands across
    an integer; the "vpu" LayerNorm as K4's); its output bit-equal to the
    twin's last step on its own codes, and, where every code is the twin's,
    within one bf16 ulp of the twin's largest magnitude.

jax is imported inside the JAX-side helpers only, so the CUDA tests run on
a machine without it:  python -m pytest tests/test_torch_kb_attribution.py
-m cuda --noconftest -q -p no:randomly
"""

import pathlib

import numpy as np
import pytest
import torch

from debias_vision_lang_torch.ops import fused_block_q as fbq
from kb_helpers import _jnp, _layer, _np32, _pallas_ops, _t, _ulp, _x, capture, interpret

torch.set_num_threads(1)

S, D, H, F = 197, 768, 12, 3072  # ViT-B/16: the bodies' width
B = 2
CSRC = pathlib.Path(fbq.__file__).resolve().parent.parent / "csrc"
BODIES = {"mlp": "mlp_kernel", "attn": "attn_kernel"}
CASES = [(blk, mode) for blk in BODIES for mode in fbq.ATTR_MODES]
# the codes each body hands to _dot_q / _quant_rows, in call order: (the
# twin's scratch key of the codes, of their row scales)
CALLS = {("mlp", "full"): ["xq", "xq", "hq", "hq"], ("mlp", "mxu"): ["xq", "hq"],
         ("mlp", "vpu"): ["xq", "hq"], ("attn", "full"): ["xq", "xq", "aq", "aq"],
         ("attn", "mxu"): ["xq", "aq"], ("attn", "vpu"): ["xq", "aq"]}
SCALES = {"xq": "xs", "hq": "hs", "aq": "as"}
EDGES = [300.0, -300.0, 127.9, -0.7, 2.5, 128.0, -129.0, float("nan"), 1e10, float("inf"),
         -float("inf"), -128.0, -128.5, 127.0, -127.9, 0.0, -0.0, 1e-30, 255.0, 256.0]


@pytest.fixture(scope="module")
def captured():
    return capture(("q_attribution",), {"ATTR_BATCH": 1, "ATTR_STEPS": 1})


@pytest.fixture(scope="module")
def layer():
    return _layer(D, seed=19)


@pytest.fixture(scope="module")
def x_in():
    """The script's inputs: N(0, 0.25) rounded to bf16, as numpy f32."""
    import jax.numpy as jnp

    x = _jnp(_x(B, S, D, seed=19) * 0.5, jnp.bfloat16)
    return np.asarray(x.astype(jnp.float32))


def _body(captured, blk, mode):
    (kern,) = [k for k in captured[BODIES[blk]] if k.keywords == {"mode": mode}]
    return kern


class _Out:
    """A stand-in for the body's output ref: keeps what it is assigned."""

    def __init__(self, dtype):
        self.dtype, self.value = dtype, None

    def __setitem__(self, idx, value):
        self.value = value


def recorded(kern, x, ops):
    """Run a captured body under ``jax.jit``, one image at a time as its grid
    does, with the closure's ``_dot_q`` and ``_quant_rows`` wrapped to keep
    the codes and row scales they are handed or return.  Returns (output,
    [(codes, scales)] in call order), each over all images."""
    import jax
    import jax.numpy as jnp

    fn = kern.func
    cells = dict(zip(fn.__code__.co_freevars, fn.__closure__))
    orig = {n: cells[n].cell_contents for n in ("_dot_q", "_quant_rows")}
    rec = []

    def dot_q(xq, xs, *rest):
        rec.append((xq, xs))
        return orig["_dot_q"](xq, xs, *rest)

    def quant_rows(v):
        q, s = orig["_quant_rows"](v)
        rec.append((q, s))
        return q, s

    @jax.jit
    def one(xi, ops):
        rec.clear()
        out = _Out(xi.dtype)
        kern(xi, *ops, out)
        return out.value, list(rec)

    cells["_dot_q"].cell_contents, cells["_quant_rows"].cell_contents = dot_q, quant_rows
    try:
        runs = [one(x[i:i + 1], ops) for i in range(x.shape[0])]
    finally:
        for n, v in orig.items():
            cells[n].cell_contents = v
    out = jnp.concatenate([r[0] for r in runs])
    calls = [tuple(np.concatenate([np.asarray(r[1][j][k]) for r in runs]) for k in (0, 1))
             for j in range(len(runs[0][1]))]
    return out, calls


def _twin(blk, mode, xt, block, scratch=None):
    if blk == "mlp":
        return fbq.mlp_block_q_attr(xt, *map(_t, block), mode=mode, scratch=scratch)
    return fbq.attention_block_q_attr(xt, *map(_t, block), heads=H, mode=mode, scratch=scratch)


def test_every_body_was_captured(captured):
    for name in BODIES.values():
        assert [k.keywords for k in captured[name]] == [{"mode": m} for m in fbq.ATTR_MODES]
        assert captured.bb[name] == [1, 1, 1]


@pytest.mark.parametrize("blk,mode", CASES, ids=[f"{b}-{m}" for b, m in CASES])
def test_body_matches_its_counterpart(captured, layer, x_in, blk, mode):
    import jax.numpy as jnp

    block = layer[0] if blk == "attn" else layer[1]
    ops = _pallas_ops(block)
    x = _jnp(x_in, jnp.bfloat16)
    ref = interpret(_body(captured, blk, mode), x, ops, bb=1)
    xt = _t(x_in, torch.bfloat16)
    sk = {}
    got = _twin(blk, mode, xt, block, scratch=sk)
    ref32, got32 = _np32(ref.astype(jnp.float32)), _np32(got)
    ulp = _ulp(ref32)
    if mode == "full":
        from debias_vision_lang_tpu.ops import fused_block_q as jfbq

        entry = jfbq.mlp_block_q if blk == "mlp" else jfbq.attention_block_q
        kw = {} if blk == "mlp" else {"heads": H}
        same = _np32(entry(x, *map(_jnp, block), bb=1, interpret=True, **kw).astype(jnp.float32))
        if blk == "attn":
            np.testing.assert_array_equal(ref32, same)
        else:
            assert np.abs(ref32 - same).max() <= ulp and (ref32 != same).mean() <= 1e-3
        assert got.dtype == torch.bfloat16
        assert np.abs(got32 - ref32).max() <= ulp
        return
    out, calls = recorded(_body(captured, blk, mode), x, ops)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
    agree = np.ones((B, S), bool)
    for key, (codes, scales) in zip(CALLS[(blk, mode)], calls):
        mine = sk[key].numpy()
        assert codes.dtype == np.int8 and codes.shape == mine.shape
        diff = np.abs(codes.astype(np.int32) - mine.astype(np.int32))
        if mode == "mxu":
            assert diff.max() == 0, f"{key}: {int((diff > 0).sum())} codes differ"
            np.testing.assert_array_equal(np.broadcast_to(scales, (B, S, 1)),
                                          sk[SCALES[key]].numpy())
        else:
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (key, diff.max())
        agree &= (diff == 0).all(-1)
    err = np.abs(got32 - ref32).max(-1)
    assert agree.any() and err[agree].max() <= ulp, f"{err[agree].max()} > 1 bf16 ulp {ulp}"
    assert err.max() <= ulp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_to_s8_sat_is_xlas_conversion(dtype):
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    sweep = np.concatenate([np.asarray(EDGES, np.float32),
                            rng.normal(size=4096).astype(np.float32) * 100,
                            rng.uniform(-130, 130, 4096).astype(np.float32),
                            np.arange(-1300, 1300, dtype=np.float32) / 10])
    xj = _jnp(sweep, getattr(jnp, dtype))
    want = np.asarray(xj.astype(jnp.int8))
    got = fbq.to_s8_sat(torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))).numpy()
    np.testing.assert_array_equal(got, want)
    edges = fbq.to_s8_sat(torch.tensor(EDGES[:9])).tolist()
    assert edges == [127, -128, 127, 0, 2, 127, -128, 0, 127]


def test_static_and_unit_codes():
    """The "mxu" casts: x's codes clip(x 16, +-127) toward zero with row
    scale 1/16 (-128 never), the others saturate at -128 with row scale 1."""
    x = torch.tensor([[[0.9, -0.9, 8.0, -8.0, -9.0, 7.99, -0.03, float("nan")]]])
    xq, xs = fbq.static_q(x.to(torch.bfloat16))
    assert xq.tolist() == [[[14, -14, 127, -127, -127, 127, 0, 0]]]
    assert xs.tolist() == [[[1 / 16]]]
    aq, a_s = fbq.unit_q(torch.tensor([[-200.0, -127.9, 3.99]]))
    assert aq.tolist() == [[-128, -127, 3]] and a_s.tolist() == [[1.0]]


def test_vpu_core_rows_are_one_over_s():
    """Each "vpu" score row is constant, so every attention value is
    bf16(1 / S), and its quantize pass gives codes of 127."""
    qkv = torch.randn(2, 13, 3 * 128).to(torch.bfloat16)
    attn = fbq.attention_core_vpu(qkv, 2)
    assert torch.equal(attn, torch.full_like(attn, 1 / 13))
    aq, _ = fbq.quant_rows(attn.float())
    assert torch.equal(aq, torch.full_like(aq, 127))


def test_mxu_core_has_no_softmax():
    """The "mxu" core: P V of the scaled scores themselves, rounded to bf16."""
    g = torch.Generator().manual_seed(3)
    qkv = torch.randn(1, 5, 3 * 64, generator=g).to(torch.bfloat16)
    q, k, v = (t.float() for t in qkv.split(64, -1))
    p = (q @ k.transpose(1, 2) / 8).to(torch.bfloat16).float()
    assert torch.equal(fbq.attention_core_nosoftmax(qkv, 1), (p @ v).to(torch.bfloat16))


@pytest.mark.parametrize("blk", list(BODIES))
def test_full_mode_is_k3_k4(layer, blk):
    x = _t(_x(2, 9, D, seed=4) * 0.5, torch.bfloat16)
    block = list(map(_t, layer[0] if blk == "attn" else layer[1]))
    if blk == "mlp":
        assert torch.equal(fbq.mlp_block_q_attr(x, *block, mode="full"),
                           fbq.mlp_block_q(x, *block))
    else:
        assert torch.equal(fbq.attention_block_q_attr(x, *block, heads=H, mode="full"),
                           fbq.attention_block_q(x, *block, heads=H))


def test_modes_and_counters():
    attn, mlp = ([_t(a) for a in h] for h in _layer(64))
    x = _t(_x(2, 9, 64), torch.bfloat16)
    for entry, args, kw in ((fbq.mlp_block_q_attr, mlp, {}),
                            (fbq.attention_block_q_attr, attn, {"heads": 1})):
        with pytest.raises(ValueError, match="mode must be one of"):
            entry(x, *args, mode="alu", **kw)
    fbq.reset_launches()
    for mode in fbq.ATTR_MODES:  # the CPU twins count nothing
        fbq.mlp_block_q_attr(x, *mlp, mode=mode)
        fbq.attention_block_q_attr(x, *attn, heads=1, mode=mode)
    assert set(fbq.KB_LAUNCHES.values()) == {0} and set(fbq.LAUNCHES.values()) == {0}
    keys = {f"{e}_attr_{m}" for e in ("mlp_block_q", "attention_block_q") for m in ("mxu", "vpu")}
    assert keys <= set(fbq.KB_LAUNCHES)
    for k in keys:
        fbq.KB_LAUNCHES[k] = 3
    fbq.reset_launches()
    assert all(fbq.KB_LAUNCHES[k] == 0 for k in keys)


def test_the_library_exports_the_attribution_entries():
    cu = (CSRC / "fused_block_q.cu").read_text()
    for entry in ("dvl_attention_block_q_attr_mxu", "dvl_attention_block_q_attr_vpu"):
        assert f"int {entry}(" in cu
    impl = cu[cu.index("int attention_block_q_impl("):cu.index("int mlp_block_q_impl(")]
    assert "AQ_ATTR_MXU" in impl and "NORM_OFF" in impl and "launch_attention_vpu_core(" in impl
    mlp = cu[cu.index("int mlp_block_q_impl("):]
    assert "launch_gemm_s8<EQ_BIAS_S8>(" in mlp and "launch_bcast_rows<EQ_RESID_BIAS>(" in mlp
    cast = cu[cu.index("uint32_t s8_trunc("):cu.index("cast_s8_kernel(")]
    assert "__float2int_rz(" in cast and "rintf" not in cast  # truncation, not rounding
    # the softmax-off mode on both cores; the long core skips its first pass
    short = (CSRC / "attention_wgmma.cuh").read_text()
    long_ = (CSRC / "attention_long.cuh").read_text()
    assert "norm_after == NORM_OFF" in short
    assert "pass = norm_after == NORM_OFF ? 1 : 0" in long_
    assert "kt < (norm_after == NORM_OFF ? 0 : nkt)" in long_


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


def _own_codes(blk, mode, x, sk, block):
    """The twin's conversion of the kernel's own rows: {codes: (q, scale)}
    ("mxu": x's static cast, and the cast of its own attention rows or of
    the hidden from its own x codes, whose up product is exact)."""
    c = "hq" if blk == "mlp" else "aq"
    if mode == "vpu":
        return {"xq": fbq.quant_rows(sk["xn"]),
                c: fbq.quant_rows(sk["h" if blk == "mlp" else "attn"])}
    rows = (fbq.dot_q(sk["xq"], sk["xs"], block[2], block[3]) + block[4].float()
            if blk == "mlp" else sk["attn"])
    return {"xq": fbq.static_q(x), c: fbq.unit_q(rows)}


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(4, S), (3, 77)])
@pytest.mark.parametrize("blk,mode", [(b_, m) for b_ in BODIES for m in ("mxu", "vpu")])
@pytest.mark.parametrize("scale", [1.0, 1 / 16])
def test_cuda_attr_matches_twin(cuda, blk, mode, b, s, scale):
    attn, mlp = ([_t(a).to(cuda) for a in h] for h in _layer(D, seed=21))
    block = attn if blk == "attn" else mlp
    kw = ({"w1_qt": mlp[2].t().contiguous(), "w2_qt": mlp[5].t().contiguous()} if blk == "mlp"
          else {"wqkv_qt": attn[2].t().contiguous(), "wo_qt": attn[5].t().contiguous(),
                "heads": H})
    x = torch.from_numpy(_x(b, s, D, seed=s) * scale).to(cuda, torch.bfloat16)
    entry = fbq.mlp_block_q_attr if blk == "mlp" else fbq.attention_block_q_attr
    plain = fbq.mlp_block_q_attr_plain if blk == "mlp" else fbq.attention_block_q_attr_plain
    fbq.reset_launches()
    sk = {}
    got = entry(x, *block, mode=mode, **kw, scratch=sk)
    torch.cuda.synchronize()
    name = f"{'mlp_block_q' if blk == 'mlp' else 'attention_block_q'}_attr_{mode}"
    assert fbq.KB_LAUNCHES[name] == 1 and sum(fbq.LAUNCHES.values()) == 0
    for c, (q, sc) in _own_codes(blk, mode, x, sk, block).items():
        assert torch.equal(q, sk[c]) and torch.equal(sc.expand_as(sk[SCALES[c]]),
                                                     sk[SCALES[c]]), c
    c, cs = ("hq", "hs") if blk == "mlp" else ("aq", "as")
    part = (fbq.dot_q(sk[c], sk[cs], block[5], block[6]) if mode == "mxu"
            else fbq.bcast_rows(sk[c], sk[cs], D))
    last = ((x.float() + block[7]) + part if blk == "mlp" else x.float() + (part + block[7]))
    assert torch.equal(got, last.to(torch.bfloat16))
    sr = {}
    ref = plain(x, *block, mode=mode, **({} if blk == "mlp" else {"heads": H}), scratch=sr)
    n_diff = 0
    for key in ("xq", c):
        diff = (sk[key].int() - sr[key].int()).abs()
        assert diff.max().item() <= 1 and diff.ne(0).float().mean().item() <= 1e-3, key
        n_diff += int(diff.ne(0).sum())
    within = (got.float() - ref.float()).abs().max().item()
    assert within <= _ulp(_np32(ref.cpu())) or n_diff > 0


@pytest.mark.cuda
def test_cuda_mxu_attention_on_the_long_core(cuda):
    attn = [_t(a).to(cuda) for a in _layer(D, seed=22)[0]]
    x = torch.from_numpy(_x(2, 400, D, seed=5)).to(cuda, torch.bfloat16)
    fbq.reset_launches()
    sk = {}
    got = fbq.attention_block_q_attr(x, *attn, heads=H, mode="mxu", wqkv_qt=attn[2].t().contiguous(),
                                     wo_qt=attn[5].t().contiguous(), scratch=sk)
    torch.cuda.synchronize()
    assert fbq.CORE_ROUTES == {"short": 0, "long": 1}
    assert torch.equal(sk["aq"], fbq.to_s8_sat(sk["attn"]))
    ref = fbq.attention_block_q_attr_plain(x, *attn, heads=H, mode="mxu")
    assert (got.float() - ref.float()).abs().max().item() <= _ulp(_np32(ref.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("blk", list(BODIES))
def test_cuda_full_mode_is_k3_k4(cuda, blk):
    attn, mlp = ([_t(a).to(cuda) for a in h] for h in _layer(D, seed=23))
    x = torch.from_numpy(_x(2, S, D, seed=6)).to(cuda, torch.bfloat16)
    fbq.reset_launches()
    if blk == "mlp":
        kw = {"w1_qt": mlp[2].t().contiguous(), "w2_qt": mlp[5].t().contiguous()}
        got = fbq.mlp_block_q_attr(x, *mlp, mode="full", **kw)
        want = fbq.mlp_block_q(x, *mlp, **kw)
        counter = "mlp_block_q"
    else:
        kw = {"wqkv_qt": attn[2].t().contiguous(), "wo_qt": attn[5].t().contiguous()}
        got = fbq.attention_block_q_attr(x, *attn, heads=H, mode="full", **kw)
        want = fbq.attention_block_q(x, *attn, heads=H, **kw)
        counter = "attention_block_q"
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert fbq.LAUNCHES[counter] == 2 and sum(fbq.KB_LAUNCHES.values()) == 0
