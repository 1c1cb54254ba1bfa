"""The int8 tensor-parallel slot entries (``ops/fused_block_q.py::
attention_block_q_heads`` / ``mlp_block_q_cols``; csrc/fused_block_q.cu).

On the card a slot opens with one pass that normalises x and quantizes it
(``ln_quant_rows_kernel``), and takes its row amax as the max over the bit
patterns of |v|: the attention slot in a warp-a-row pass, the MLP slot in
its up GEMM's epilogue (an integer ``atomicMax`` per tile and row).

  * The bit-order max: over non-negative float32 values (zeros, subnormals,
    normals, inf) the int32 view's max is the float max, bit for bit, and
    over bf16 values the same through their f32 bits; a row holding a NaN
    gives a NaN, as ``row_amax`` (torch's amax) does.
  * The g = 1 slot of a (1, 8) split of 12 heads (ViT-B/16's split, at
    width 96) against JAX's int8 attention half on the (1, 8) mesh of its
    virtual CPU devices (``quantized_resblock_pspecs``' placement): the
    slot's rows are JAX's at that head's columns within 1e-5, its amax
    their row max; at bfloat16 the slots' rows are K3's twin's own columns
    bit for bit.
  * ``cuda`` (skipped without a card): every slot's attention rows and
    hidden equal K3's / K4's at its columns bit for bit and each amax is
    ``row_amax`` of them, at registry and off-registry widths (odd D, a
    row past the registers' 2,048 values, padded head dims, the long
    core); K4's hidden equals the slot's at m = 1; a NaN reaches the amax.
"""

import numpy as np
import pytest
import torch

from debias_vision_lang_torch.ops import fused_block as fb
from debias_vision_lang_torch.ops import fused_block_q as fbq
from debias_vision_lang_torch.ops.quant import QWeight
from debias_vision_lang_torch.parallel import tensor as tpar

torch.set_num_threads(1)


def _bits_max(v: np.ndarray) -> np.ndarray:
    """The row max of |v| taken on the int32 view of its float32 bits (the
    kernels' fold), as float32."""
    bits = np.abs(v.astype(np.float32)).view(np.int32)
    return bits.max(axis=-1).view(np.float32)


def _special_rows(rng):
    tiny = np.finfo(np.float32).tiny
    sub = np.array([1e-45, 3e-42, tiny / 2, tiny * 0.999], np.float32)  # subnormals
    rows = [np.zeros(16, np.float32), -np.zeros(16, np.float32),
            np.concatenate([sub, -sub, np.zeros(8, np.float32)]),
            np.concatenate([sub, [tiny, -tiny], np.zeros(10, np.float32)]).astype(np.float32),
            np.array([np.inf, 1.0, -3.0] + [0.0] * 13, np.float32),
            np.array([-np.inf, np.finfo(np.float32).max] + [2.0] * 14, np.float32),
            np.array([np.finfo(np.float32).max, -np.finfo(np.float32).max] + [0.5] * 14,
                     np.float32)]
    rows += [(rng.normal(size=16) * 10.0 ** rng.integers(-40, 38)).astype(np.float32)
             for _ in range(64)]
    return np.stack(rows)


def test_bit_order_max_is_the_float_max():
    rows = _special_rows(np.random.default_rng(0))
    got = _bits_max(rows)
    want = np.abs(rows).max(axis=-1)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    # the twin's amax agrees
    assert torch.equal(fbq.row_amax(torch.from_numpy(rows))[:, 0], torch.from_numpy(want))


def test_bit_order_max_over_bf16_rows_is_the_float_max():
    """bf16 values: the f32 bits are the bf16 bits shifted by 16, so the max
    over (bits & 0x7fff) << 16 is the f32 max of |v|."""
    rows = torch.from_numpy(_special_rows(np.random.default_rng(1))).to(torch.bfloat16)
    b16 = rows.view(torch.int16).numpy().astype(np.int32) & 0x7FFF
    got = torch.from_numpy((b16.max(axis=-1) << 16).astype(np.int32).view(np.float32))
    assert torch.equal(got, fbq.row_amax(rows)[:, 0])


@pytest.mark.parametrize("where", [0, 7, 15])
def test_a_nan_row_gives_a_nan_as_row_amax(where):
    rows = _special_rows(np.random.default_rng(2))[:8].copy()
    rows[3, where] = np.nan
    rows[5, where] = -np.nan
    got = _bits_max(rows)
    twin = fbq.row_amax(torch.from_numpy(rows))[:, 0].numpy()
    assert np.isnan(got[3]) and np.isnan(got[5]) and np.isnan(twin[3]) and np.isnan(twin[5])
    ok = [i for i in range(8) if i not in (3, 5)]
    assert np.array_equal(got[ok].view(np.int32), twin[ok].view(np.int32))


def _quant_block(d, seed):
    """A block's LN and int8 q | k | v / w1 weights from numpy draws (JAX's
    quantize_weight, then the port's copies of the same codes)."""
    rng = np.random.default_rng(seed)

    def rn(*shape, std=1.0):
        return (rng.normal(size=shape) * std).astype(np.float32)

    return {"ln_1": (1 + rn(d, std=0.1), rn(d, std=0.1)),
            "wqkv": rn(d, 3 * d, std=d ** -0.5), "bqkv": rn(3 * d, std=0.1),
            "ln_2": (1 + rn(d, std=0.1), rn(d, std=0.1)),
            "w1": rn(d, 4 * d, std=(2 * d) ** -0.5), "b1": rn(4 * d, std=0.1)}


def test_g1_slot_of_eight_matches_jax_sharded_int8_attention():
    """ViT-B/16's (1, 8) split at width 96 (12 heads of 8): slot 0 holds one
    head.  JAX computes the attention half up to the attention rows with
    the block placed on its (1, 8) mesh (wqkv / bqkv column-sharded, the
    LayerNorm replicated: ``quantized_resblock_pspecs``), float32."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from debias_vision_lang_tpu.models.layers import layer_norm
    from debias_vision_lang_tpu.ops.attention import attention_reference
    from debias_vision_lang_tpu.ops.quant import int8_matmul, quantize_resblocks
    from debias_vision_lang_tpu.parallel.mesh import create_mesh, quantized_resblock_pspecs

    d, heads, m, b, s = 96, 12, 8, 3, 17
    hd = d // heads
    p = _quant_block(d, seed=25)
    z = np.zeros
    stacked = {"ln_1": {"scale": p["ln_1"][0][None], "bias": p["ln_1"][1][None]},
               "ln_2": {"scale": p["ln_2"][0][None], "bias": p["ln_2"][1][None]},
               "attn": {"wqkv": p["wqkv"][None], "bqkv": p["bqkv"][None],
                        "wo": z((1, d, d), np.float32), "bo": z((1, d), np.float32)},
               "mlp": {"w1": p["w1"][None], "b1": p["b1"][None],
                       "w2": z((1, 4 * d, d), np.float32), "b2": z((1, d), np.float32)}}
    q = quantize_resblocks(jax.tree.map(jnp.asarray, stacked))
    mesh = create_mesh((1, m), devices=jax.devices()[:m])
    q = jax.tree.map(lambda a, spec: jax.device_put(a, NamedSharding(mesh, spec)), q,
                     quantized_resblock_pspecs())
    layer = jax.tree.map(lambda a: a[0], q)
    x = np.random.default_rng(26).normal(size=(b, s, d)).astype(np.float32)

    @jax.jit
    def attention_rows(layer, x):
        qkv = int8_matmul(layer_norm(layer["ln_1"], x), layer["attn"]["wqkv"],
                          layer["attn"]["bqkv"])
        qh, kh, vh = (t.reshape(b, s, heads, hd).transpose(0, 2, 1, 3)
                      for t in jnp.split(qkv, 3, axis=-1))
        return attention_reference(qh, kh, vh).transpose(0, 2, 1, 3).reshape(b, s, d)

    o = np.asarray(attention_rows(layer, jnp.asarray(x)))
    wq = torch.from_numpy(np.array(q["attn"]["wqkv"]["q"][0]))
    ws = torch.from_numpy(np.array(q["attn"]["wqkv"]["scale"][0]))
    bq = torch.from_numpy(p["bqkv"])
    ln = tuple(map(torch.from_numpy, p["ln_1"]))
    for j in (0, 1):  # slot 0 holds head 0, slot 1 heads 1 and 2
        lo, hi = tpar.head_group(heads, m, j)
        cols = tpar.head_columns(d, m, j, heads)
        rows, amax = fbq.attention_block_q_heads(torch.from_numpy(x), *ln, wq[:, cols],
                                                 ws[:, cols], bq[cols], heads=hi - lo)
        want = o[..., lo * hd:hi * hd]
        np.testing.assert_allclose(rows.numpy(), want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(amax.numpy()[..., 0], np.abs(want).max(-1), atol=1e-5,
                                   rtol=0)
        assert torch.equal(amax, fbq.row_amax(rows))


@pytest.mark.parametrize("m", [2, 8])
def test_bf16_slot_rows_are_k3s_columns(m):
    """On the CPU the slots' data flow (the twins) at bfloat16: each slot's
    attention rows and hidden are K3's / K4's twin's own columns, bit for
    bit, and each amax is their row amax."""
    d, heads, b, s = 96, 12, 2, 13
    p = _quant_block(d, seed=27)
    wqkv, w1 = QWeight(torch.from_numpy(p["wqkv"])), QWeight(torch.from_numpy(p["w1"]))
    bqkv, b1 = torch.from_numpy(p["bqkv"]), torch.from_numpy(p["b1"])
    ln1, ln2 = tuple(map(torch.from_numpy, p["ln_1"])), tuple(map(torch.from_numpy, p["ln_2"]))
    x = torch.from_numpy(np.random.default_rng(28).normal(size=(b, s, d))
                         .astype(np.float32)).to(torch.bfloat16)
    k3, k4 = {}, {}
    zero_w = QWeight(torch.zeros(d, d))
    fbq.attention_block_q(x, *ln1, wqkv.q, wqkv.scale, bqkv, zero_w.q, zero_w.scale,
                          torch.zeros(d), heads=heads, scratch=k3)
    zero_w2 = QWeight(torch.zeros(4 * d, d))
    fbq.mlp_block_q(x, *ln2, w1.q, w1.scale, b1, zero_w2.q, zero_w2.scale, torch.zeros(d),
                    scratch=k4)
    hd, f = d // heads, 4 * d
    for j in range(m):
        lo, hi = tpar.head_group(heads, m, j)
        cols = tpar.head_columns(d, m, j, heads)
        rows, amax = fbq.attention_block_q_heads(x, *ln1, wqkv.q[:, cols], wqkv.scale[:, cols],
                                                 bqkv[cols], heads=hi - lo)
        assert torch.equal(rows.float(), k3["attn"][..., lo * hd:hi * hd])
        assert torch.equal(amax, fbq.row_amax(rows))
        hid = slice(j * f // m, (j + 1) * f // m)
        h, hmax = fbq.mlp_block_q_cols(x, *ln2, w1.q[:, hid], w1.scale[:, hid], b1[hid])
        assert torch.equal(h, k4["h"][..., hid])
        assert torch.equal(hmax, fbq.row_amax(h))


# ---------------------------------------------------------------------------
# CUDA: the slot entries against K3 / K4 on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled with nvcc for sm_90a "
                    "and have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_block(d, dev, seed):
    p = _quant_block(d, seed)
    wqkv, w1 = QWeight(torch.from_numpy(p["wqkv"]).to(dev)), QWeight(
        torch.from_numpy(p["w1"]).to(dev))
    zo, z2 = QWeight(torch.zeros(d, d, device=dev)), QWeight(torch.zeros(4 * d, d, device=dev))
    t = {k: tuple(torch.from_numpy(a).to(dev) for a in p[k]) for k in ("ln_1", "ln_2")}
    t.update(wqkv=wqkv, w1=w1, zo=zo, z2=z2, bqkv=torch.from_numpy(p["bqkv"]).to(dev),
             b1=torch.from_numpy(p["b1"]).to(dev), zero=torch.zeros(d, device=dev))
    return t


def _k3_k4(x, t, heads, causal):
    k3, k4 = {}, {}
    fbq.attention_block_q(x, *t["ln_1"], t["wqkv"].q, t["wqkv"].scale, t["bqkv"], t["zo"].q,
                          t["zo"].scale, t["zero"], heads=heads, causal=causal,
                          wqkv_qt=t["wqkv"].qt, wo_qt=t["zo"].qt, scratch=k3)
    fbq.mlp_block_q(x, *t["ln_2"], t["w1"].q, t["w1"].scale, t["b1"], t["z2"].q, t["z2"].scale,
                    t["zero"], w1_qt=t["w1"].qt, w2_qt=t["z2"].qt, scratch=k4)
    return k3, k4


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,heads,m,causal", [
    (4, 197, 768, 12, 8, False), (4, 197, 768, 12, 2, False), (5, 77, 512, 8, 8, True),
    (5, 77, 512, 8, 2, True), (2, 400, 768, 12, 2, False), (3, 77, 200, 2, 2, False),
    (3, 33, 203, 7, 2, False), (2, 65, 1280, 16, 2, False), (2, 50, 1664, 16, 4, False),
    (2, 33, 2560, 20, 2, False)])
def test_cuda_slots_are_k3_and_k4_columns(cuda, b, s, d, heads, m, causal):
    """Every slot's attention rows (cropped from its padded layout) and
    hidden are K3's / K4's at its columns bit for bit, each amax their
    row_amax; one launch of each entry a slot.  D = 203 takes the fused
    pass's value-by-value route (odd D), D = 2,560 its re-reading one."""
    t = _card_block(d, cuda, seed=d + m)
    x = torch.from_numpy(np.random.default_rng(b + s).normal(size=(b, s, d))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    k3, k4 = _k3_k4(x, t, heads, causal)
    hd, f = d // heads, 4 * d
    fbq.reset_launches()
    busy = 0
    for j in range(m):
        lo, hi = tpar.head_group(heads, m, j)
        hid = slice(j * f // m, (j + 1) * f // m)
        w1q = t["w1"].q[:, hid]
        h, hmax = fbq.mlp_block_q_cols(x, *t["ln_2"], w1q, t["w1"].scale[:, hid], t["b1"][hid],
                                       w1_qt=w1q.t().contiguous())
        plan = fb.mlp_plan(d, f // m)
        h = plan.crop_hidden(h)
        assert torch.equal(h, k4["h"][..., hid]), f"slot {j}: hidden is not K4's"
        assert torch.equal(hmax, fbq.row_amax(h)), f"slot {j}: hidden amax"
        if hi == lo:
            continue
        busy += 1
        cols = tpar.head_columns(d, m, j, heads).to(cuda)
        wq = t["wqkv"].q[:, cols]
        rows, amax = fbq.attention_block_q_heads(x, *t["ln_1"], wq, t["wqkv"].scale[:, cols],
                                                 t["bqkv"][cols], heads=hi - lo, causal=causal,
                                                 wqkv_qt=wq.t().contiguous())
        assert torch.equal(amax, fbq.row_amax(rows)), f"slot {j}: attention amax"
        rows = fb.group_plan(d, hd, hi - lo).crop_heads(rows)
        assert torch.equal(rows.float(), k3["attn"][..., lo * hd:hi * hd]), \
            f"slot {j}: rows are not K3's"
    torch.cuda.synchronize()
    key = "attention_block_q_heads_causal" if causal else "attention_block_q_heads"
    assert fbq.TP_LAUNCHES[key] == busy and fbq.TP_LAUNCHES["mlp_block_q_cols"] == m


@pytest.mark.cuda
@pytest.mark.parametrize("d,act", [(768, "quick_gelu"), (1024, "gelu"), (200, "quick_gelu")])
def test_cuda_k4_hidden_is_the_slot_hidden_at_one_slot(cuda, d, act):
    """K4's up GEMM (EQ_BIAS_QGELU / EQ_BIAS_GELU) and the slot's with the
    amax epilogue write the same hidden, bit for bit, and it is the twin's
    up-projection of K4's own codes within 1e-5 of its largest magnitude."""
    t = _card_block(d, cuda, seed=d)
    x = torch.from_numpy(np.random.default_rng(d).normal(size=(4, 77, d))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    k4 = {}
    fbq.mlp_block_q(x, *t["ln_2"], t["w1"].q, t["w1"].scale, t["b1"], t["z2"].q, t["z2"].scale,
                    t["zero"], act_kind=act, w1_qt=t["w1"].qt, w2_qt=t["z2"].qt, scratch=k4)
    h, hmax = fbq.mlp_block_q_cols(x, *t["ln_2"], t["w1"].q, t["w1"].scale, t["b1"],
                                   act_kind=act, w1_qt=t["w1"].qt)
    h = fb.mlp_plan(d, 4 * d).crop_hidden(h)
    assert torch.equal(h, k4["h"]) and torch.equal(hmax, fbq.row_amax(h))
    own = fb._act(fbq.dot_q(k4["xq"], k4["xs"], t["w1"].q, t["w1"].scale) + t["b1"], act)
    assert (h - own).abs().max().item() <= 1e-5 * own.abs().max().item()


@pytest.mark.cuda
def test_cuda_a_nan_reaches_the_amax(cuda):
    """A NaN bias lane makes a NaN in every row: the MLP slot's epilogue
    and the attention slot's amax pass give those rows a NaN, as
    ``row_amax`` does."""
    d, heads = 768, 12
    t = _card_block(d, cuda, seed=5)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 50, d))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    b1 = t["b1"][:384].clone()
    b1[7] = float("nan")
    w1q = t["w1"].q[:, :384]
    h, hmax = fbq.mlp_block_q_cols(x, *t["ln_2"], w1q, t["w1"].scale[:, :384], b1,
                                   w1_qt=w1q.t().contiguous())
    assert torch.isnan(h[..., 7]).all() and torch.isnan(hmax).all()
    assert torch.isnan(fbq.row_amax(h)).all()
    cols = tpar.head_columns(d, 6, 0, heads).to(cuda)
    bq = t["bqkv"][cols].clone()
    bq[2 * 128 + 3] = float("nan")  # a v lane of the slot's first head
    wq = t["wqkv"].q[:, cols]
    rows, amax = fbq.attention_block_q_heads(x, *t["ln_1"], wq, t["wqkv"].scale[:, cols], bq,
                                             heads=2, wqkv_qt=wq.t().contiguous())
    assert torch.isnan(rows).any(-1).all() and torch.isnan(amax).all()
    assert torch.isnan(fbq.row_amax(rows)).all()
