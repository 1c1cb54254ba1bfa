"""A NaN in the int8 quantize passes, as JAX's ``_quant_rows`` takes it.

``jnp.max`` and ``jnp.maximum`` propagate a NaN, so a row holding one gets
a NaN amax, a NaN scale (``max(amax / 127, 1e-8)``), codes 0 (XLA converts
NaN to 0) and a NaN output row.  The port's twins define the same codes
(``fused_block_q.q_codes``), and its CUDA passes take the amaxes and the
clamp with ``max.NaN`` (csrc/attention_qq.cuh::fmax_nan).

CPU: ``quant_rows``, ``quant_rows_given_amax``, ``rows_q_partial_plain``,
``tp_reduce_q_plain`` and the K3 / K4 twins against the JAX functions (the
int8 Pallas kernels in interpret mode) with a NaN row in x, in a slot's
rows and in one slot's amax: the NaN row comes out NaN with codes 0, and
every finite row is bit-equal to the run without the NaN.  ``cuda``
(skipped without a card): the same rows through K3, K4, the int8 slots,
``rows_q_partial`` and KB (a) 1's core on the card against their twins.
"""

import numpy as np
import pytest
import torch

from debias_vision_lang_torch.ops import fused_block as fb
from debias_vision_lang_torch.ops import fused_block_q as fbq
from debias_vision_lang_torch.ops import quant

torch.set_num_threads(1)

B, S, D, H = 3, 13, 32, 2
NAN_AT = (1, 4)  # (image, token) of the NaN row


def _rows(seed, n=6, k=40):
    return np.random.default_rng(seed).normal(size=(n, k)).astype(np.float32) * 3.0


def _jax_quant_rows(x):
    import jax.numpy as jnp

    from debias_vision_lang_tpu.ops.fused_block_q import _quant_rows

    q, s = _quant_rows(jnp.asarray(x))
    return np.asarray(q), np.asarray(s)


def _finite_rows_equal(got, ref, nan_rows):
    keep = np.ones(got.shape[0], bool)
    keep[list(nan_rows)] = False
    np.testing.assert_array_equal(got[keep], ref[keep])


@pytest.mark.parametrize("where", [0, 17, 39])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_quant_rows_nan_row_is_jaxs(where, sign):
    x = _rows(0)
    clean_q, clean_s = fbq.quant_rows(torch.from_numpy(x))
    x[2, where] = sign * np.nan
    x[4, :] = np.nan
    q, s = fbq.quant_rows(torch.from_numpy(x))
    jq, js = _jax_quant_rows(x)
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js)  # NaN where JAX has NaN
    for r in (2, 4):
        assert np.isnan(js[r, 0]) and np.isnan(s[r, 0].item())
        assert not q[r].any() and not jq[r].any()
    _finite_rows_equal(q.numpy(), clean_q.numpy(), (2, 4))
    _finite_rows_equal(s.numpy(), clean_s.numpy(), (2, 4))


def test_quant_rows_recip_nan_row_is_zero_codes():
    x = _rows(1)
    x[3, 5] = np.nan
    q, s = fbq.quant_rows_recip(torch.from_numpy(x))
    assert torch.isnan(s[3]).all() and not q[3].any()


def test_q_codes_takes_nan_to_zero_and_keeps_the_rest():
    y = torch.tensor([np.nan, -np.nan, 0.5, 1.5, -2.5, 126.6, 300.0, -300.0, -0.4])
    assert fbq.q_codes(y).tolist() == [0, 0, 0, 2, -2, 127, 127, -127, 0]


def _slot_rows(seed, m=2):
    """A row-parallel input split over m slots' columns, its weight rows."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(2, 5, 8 * m)).astype(np.float32)
    w = rng.normal(size=(8 * m, 12)).astype(np.float32)
    wq = quant.quantize_weight(torch.from_numpy(w))
    return a, wq["q"], wq["scale"]


@pytest.mark.parametrize("nan_slot", [0, 1])
def test_rows_q_partial_with_a_nan_in_one_slot_is_jaxs(nan_slot):
    """A NaN in one slot's columns of row (1, 3): every slot quantizes that
    row at the NaN max amax to codes 0 and a NaN scale, as JAX's
    ``_quant_rows`` of the whole row; the reduced row is NaN, the others
    bit-equal to the run without it and to JAX's ``_dot_q`` of its codes."""
    import jax.numpy as jnp

    from debias_vision_lang_tpu.ops.fused_block_q import _dot_q

    m = 2
    a, wq, ws = _slot_rows(3, m)
    bias = np.random.default_rng(4).normal(size=12).astype(np.float32)
    resid = np.random.default_rng(5).normal(size=(2, 5, 12)).astype(np.float32)

    def run(a):
        at = torch.from_numpy(a)
        cols = [slice(8 * j, 8 * (j + 1)) for j in range(m)]
        amaxes = [fbq.row_amax(at[..., c]) for c in cols]
        outs = [fbq.rows_q_partial_plain(at[..., c], amaxes, wq[c]) for c in cols]
        y = fbq.tp_reduce_q_plain([o[0] for o in outs], outs[0][2], ws, torch.from_numpy(bias),
                                  torch.from_numpy(resid), bias_first=False)
        return outs, y

    clean_outs, clean_y = run(a)
    a[1, 3, 8 * nan_slot + 2] = np.nan
    outs, y = run(a)
    jq, js = _jax_quant_rows(a)
    for j, (acc, aq, ascale) in enumerate(outs):
        np.testing.assert_array_equal(aq.numpy(), jq[..., 8 * j:8 * (j + 1)])
        np.testing.assert_array_equal(ascale.numpy(), js)
        assert not aq[1, 3].any() and torch.isnan(ascale[1, 3]).all()
        ok = np.ones((2, 5), bool)
        ok[1, 3] = False
        assert torch.equal(acc[torch.from_numpy(ok)], clean_outs[j][0][torch.from_numpy(ok)])
    dot = np.asarray(_dot_q(jnp.asarray(jq), jnp.asarray(js),
                            jnp.asarray(wq.numpy()), jnp.asarray(ws.numpy())))
    ref = resid + (dot + bias)
    np.testing.assert_array_equal(y.numpy(), ref)
    assert torch.isnan(y[1, 3]).all()
    ok = torch.ones(2, 5, dtype=torch.bool)
    ok[1, 3] = False
    assert torch.equal(y[ok], clean_y[ok])


def test_given_amax_with_a_nan_amax():
    a = torch.from_numpy(_rows(6))
    amax = fbq.row_amax(a)
    amax[1] = float("nan")
    q, s = fbq.quant_rows_given_amax(a, amax)
    want_q, want_s = fbq.quant_rows(a)
    assert not q[1].any() and torch.isnan(s[1]).all()
    keep = torch.arange(6) != 1
    assert torch.equal(q[keep], want_q[keep]) and torch.equal(s[keep], want_s[keep])


# ---------------------------------------------------------------------------
# K3 / K4: the twins against the int8 Pallas kernels, a NaN row in x
# ---------------------------------------------------------------------------


def _layer():
    rng = np.random.default_rng(0)

    def rn(*shape, std=1.0):
        return (rng.normal(size=shape) * std).astype(np.float32)

    def qw(w):
        t = quant.quantize_weight(torch.from_numpy(w))
        return t["q"].numpy(), t["scale"].numpy()

    attn = (1 + rn(D, std=0.1), rn(D, std=0.1), *qw(rn(D, 3 * D, std=D ** -0.5)),
            rn(3 * D, std=0.1), *qw(rn(D, D, std=D ** -0.5)), rn(D, std=0.1))
    mlp = (1 + rn(D, std=0.1), rn(D, std=0.1), *qw(rn(D, 4 * D, std=(2 * D) ** -0.5)),
           rn(4 * D, std=0.1), *qw(rn(4 * D, D, std=(4 * D) ** -0.5)), rn(D, std=0.1))
    return attn, mlp


def _keep(a):
    a = np.asarray(a)
    return torch.from_numpy(a) if a.dtype == np.int8 else torch.from_numpy(a.astype(np.float32))


def _x(nan):
    x = np.random.default_rng(1).normal(size=(B, S, D)).astype(np.float32)
    if nan:
        x[NAN_AT[0], NAN_AT[1], 7] = np.nan
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["K3", "K4"])
def test_k3_k4_twins_take_a_nan_row_as_jax(which, dtype):
    """K4: the NaN token's row alone comes out NaN; K3: its image's rows (the
    token's k and v reach every query), in JAX and in the twin alike.  The
    finite rows are bit-equal to the twin's run without the NaN and within
    the twins' bars of JAX (tests/test_torch_fused_block.py)."""
    import jax.numpy as jnp

    from debias_vision_lang_tpu.ops.fused_block_q import attention_block_q, mlp_block_q

    attn, mlp = _layer()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    outs = {}
    for nan in (False, True):
        x = _x(nan)
        if which == "K3":
            ref = attention_block_q(jnp.asarray(x).astype(jdt), *map(jnp.asarray, attn),
                                    heads=H, bb=1, interpret=True)
            got = fbq.attention_block_q(torch.from_numpy(x).to(tdt), *map(_keep, attn), heads=H)
        else:
            ref = mlp_block_q(jnp.asarray(x).astype(jdt), *map(jnp.asarray, mlp), bb=1,
                              interpret=True)
            got = fbq.mlp_block_q(torch.from_numpy(x).to(tdt), *map(_keep, mlp))
        outs[nan] = (np.asarray(ref.astype(jnp.float32)), got.float().numpy())
    ref, got = outs[True]
    bad = np.zeros((B, S), bool)
    if which == "K3":
        bad[NAN_AT[0]] = True
    else:
        bad[NAN_AT] = True
    assert np.isnan(ref[bad]).all() and np.isnan(got[bad]).all()
    assert np.isfinite(ref[~bad]).all() and np.isfinite(got[~bad]).all()
    np.testing.assert_array_equal(got[~bad], outs[False][1][~bad])
    if dtype == "float32":
        np.testing.assert_allclose(got[~bad], ref[~bad], atol=1e-4)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(ref[~bad]).max())) - 7)
        assert np.abs(got[~bad] - ref[~bad]).max() <= ulp


def test_k4_twin_codes_of_the_nan_row_are_zero():
    """The twin's LN row of the NaN token quantizes to codes 0 and a NaN
    scale, as JAX's ``_quant_rows`` of the same row."""
    _, mlp = _layer()
    x = torch.from_numpy(_x(True))
    xn = fb.ln_f32(x, torch.from_numpy(mlp[0]), torch.from_numpy(mlp[1])).float()
    q, s = fbq.quant_rows(xn)
    jq, js = _jax_quant_rows(xn.numpy())
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js)
    assert not q[NAN_AT].any() and torch.isnan(s[NAN_AT]).all()


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


def _card_layer(d, dev):
    rng = np.random.default_rng(d)

    def rn(*shape, std=1.0):
        return torch.from_numpy((rng.normal(size=shape) * std).astype(np.float32)).to(dev)

    return {"ln": (1 + rn(d, std=0.1), rn(d, std=0.1)),
            "wqkv": quant.QWeight(rn(d, 3 * d, std=d ** -0.5)), "bqkv": rn(3 * d, std=0.1),
            "wo": quant.QWeight(rn(d, d, std=d ** -0.5)), "bo": rn(d, std=0.1),
            "w1": quant.QWeight(rn(d, 4 * d, std=(2 * d) ** -0.5)), "b1": rn(4 * d, std=0.1),
            "w2": quant.QWeight(rn(4 * d, d, std=(4 * d) ** -0.5)), "b2": rn(d, std=0.1)}


def _card_x(b, s, d, dev, nan_rows=()):
    x = torch.from_numpy(np.random.default_rng(b * s).normal(size=(b, s, d))
                         .astype(np.float32)).to(dev, torch.bfloat16)
    for bi, si in nan_rows:
        x[bi, si, :] = float("nan")
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("d,heads,s", [(768, 12, 197), (512, 8, 77), (203, 7, 33),
                                       (768, 12, 400)])
def test_cuda_k3_k4_nan_row(cuda, d, heads, s):
    """A NaN row of x on the card: K4's row NaN with codes 0 and a NaN scale
    (its scratch), K3's image NaN; every other row bit-equal to the run
    without it, and the NaN pattern the twin's."""
    t = _card_layer(d, cuda)
    res = {}
    for nan in (False, True):
        x = _card_x(3, s, d, cuda, [(1, 5)] if nan else [])
        k3, k4 = {}, {}
        y3 = fbq.attention_block_q(x, *t["ln"], t["wqkv"].q, t["wqkv"].scale, t["bqkv"],
                                   t["wo"].q, t["wo"].scale, t["bo"], heads=heads,
                                   wqkv_qt=t["wqkv"].qt, wo_qt=t["wo"].qt, scratch=k3)
        y4 = fbq.mlp_block_q(x, *t["ln"], t["w1"].q, t["w1"].scale, t["b1"], t["w2"].q,
                             t["w2"].scale, t["b2"], w1_qt=t["w1"].qt, w2_qt=t["w2"].qt,
                             scratch=k4)
        res[nan] = (y3, y4, k3, k4, x)
    y3, y4, k3, k4, x = res[True]
    assert torch.isnan(y4[1, 5]).all() and not k4["xq"][1, 5].any()
    assert torch.isnan(k4["xs"][1, 5]).all() and not k4["hq"][1, 5].any()
    assert torch.isnan(y3[1]).all() and not k3["xq"][1, 5].any()
    ok = torch.ones(3, s, dtype=torch.bool, device=cuda)
    ok[1, 5] = False
    assert torch.equal(y4[ok], res[False][1][ok])
    assert torch.equal(y3[[0, 2]], res[False][0][[0, 2]])
    cpu = [v.cpu() for v in (x, *t["ln"])]
    twin4 = fbq.mlp_block_q(cpu[0], *cpu[1:], t["w1"].q.cpu(), t["w1"].scale.cpu(),
                            t["b1"].cpu(), t["w2"].q.cpu(), t["w2"].scale.cpu(), t["b2"].cpu())
    assert torch.equal(torch.isnan(twin4), torch.isnan(y4.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 8])
def test_cuda_slots_rows_q_partial_nan_row(cuda, m):
    """The int8 slots and rows_q_partial on a NaN row of x: each slot's amax
    NaN there, every slot's codes 0 and scale NaN at the maxed amax, the
    reduced row NaN; the other rows bit-equal to the unsharded K4."""
    d, f = 768, 3072
    t = _card_layer(d, cuda)
    x = _card_x(2, 50, d, cuda, [(0, 9)])
    hs, amaxes = [], []
    for j in range(m):
        hid = slice(j * f // m, (j + 1) * f // m)
        w1q = t["w1"].q[:, hid]
        h, hmax = fbq.mlp_block_q_cols(x, *t["ln"], w1q, t["w1"].scale[:, hid], t["b1"][hid],
                                       w1_qt=w1q.t().contiguous())
        hs.append((h, hid))
        amaxes.append(hmax)
        assert torch.isnan(hmax[0, 9]).all()
    parts = []
    for h, hid in hs:
        plan = fb.mlp_plan(d, f // m)
        acc, aq, ascale = fbq.rows_q_partial(h, amaxes, t["w2"].q[hid],
                                             w_qt=t["w2"].q[hid].t().contiguous(), plan=plan)
        assert not aq[0, 9].any() and torch.isnan(ascale[0, 9]).all()
        parts.append(acc)
    y = fbq.tp_reduce_q(parts, ascale, t["w2"].scale, t["b2"], x, bias_first=True)
    k4 = fbq.mlp_block_q(x, *t["ln"], t["w1"].q, t["w1"].scale, t["b1"], t["w2"].q,
                         t["w2"].scale, t["b2"], w1_qt=t["w1"].qt, w2_qt=t["w2"].qt)
    assert torch.isnan(y[0, 9]).all() and torch.equal(torch.isnan(y), torch.isnan(k4))
    ok = ~torch.isnan(k4).any(-1)
    assert torch.equal(y[ok], k4[ok])


@pytest.mark.cuda
@pytest.mark.parametrize("s,hd", [(197, 64), (400, 64), (77, 80)])
def test_cuda_qq_core_nan_row(cuda, s, hd):
    """KB (a) 1's core on a NaN qkv row (both routes): that row's q and k
    and every v column of its image reach NaN scales, so the image's output
    is NaN, as the twin's; the other image bit-equal to the run without."""
    heads = 4
    d = heads * hd
    qkv = torch.from_numpy(np.random.default_rng(s).normal(size=(2, s, 3 * d))
                           .astype(np.float32)).to(cuda)
    clean = fbq.attention_qq_core(qkv, heads)
    qkv[1, 3] = float("nan")
    got = fbq.attention_qq_core(qkv, heads)
    twin = fbq.attention_qq_core_plain(qkv.cpu(), heads, torch.bfloat16)
    assert torch.isnan(got[1]).all() and torch.isnan(twin[1]).all()
    assert torch.equal(got[0], clean[0])
