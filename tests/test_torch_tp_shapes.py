"""Tensor parallel at every split the JAX package places (debias_vision_lang_
torch/parallel/tensor.py against debias_vision_lang_tpu/parallel/mesh.py).

JAX places the stacked resblocks by PartitionSpecs: wqkv / bqkv / w1 / b1
split by column, wo / w2 by row, so its ``shard_clip_params`` takes any head
count and refuses only 3D, D or F not divisible by the model axis (a
``device_put`` divisibility ValueError).  The port splits by heads: slot j
takes heads [floor(j H / m), floor((j + 1) H / m)), uneven groups and empty
slots included, which computes the same function.

  * ``check_split`` raises exactly where JAX's ``shard_clip_params`` raises,
    over shapes that divide and shapes that do not (m up to 8, the virtual
    CPU devices JAX has here).
  * Towers under (1, 4) at H = 2 (two slots without a head), (1, 8) at
    ViT-width-96 H = 12 (slots of 1 and 2 heads) and (1, 2) at H = 3, D = 72
    (head dim 24): float32 logits within 1e-4 of JAX's sharded and
    unsharded forwards (tests/test_parallel.py's bar) and within 1e-5 of the
    port's unsharded; int8 embeddings within 1e-5 of JAX's single-device
    int8 and bit-equal to the port's unsharded int8 towers (float32 plain
    layers and bfloat16 kernel twins); one bfloat16 block through the split
    kernels' twins within one bf16 ulp of K1 / K2's twins.
  * m = 16 on a 16-slot CPU mesh against the port's unsharded forward (JAX
    has 8 devices here).
  * One reduce launch takes up to ``fused_block.TP_PARTS`` slots' partials
    and sums them in slot order, bit for bit; more slots are refused; a
    slot without a head runs no attention entry.
  * A head group's padded operand layout (``group_plan``): the kernels'
    data flow on the CPU equals the unpadded group's partial, and the
    row-parallel int8 product on padded rows equals the unpadded one.
  * ``enable_debug_nans`` on the serving batcher's threads: a NaN made by a
    CPU twin inside the worker reaches the caller as FloatingPointError.
"""

import math

import numpy as np
import pytest
import torch

from debias_vision_lang_torch.core.config import CLIPConfig, TextConfig, VisionConfig
from debias_vision_lang_torch.models.clip import CLIP, init_clip_params
from debias_vision_lang_torch.ops import fused_block as fb
from debias_vision_lang_torch.ops import fused_block_q as fbq
from debias_vision_lang_torch.ops.quant import QuantizedCLIP
from debias_vision_lang_torch.parallel import mesh as pm
from debias_vision_lang_torch.parallel import tensor as tpar

torch.set_num_threads(1)

CPU = torch.device("cpu")
# (vision width, vision heads, model slots): H = 2 over 4, ViT-B/16's 12
# heads over 8 at width 96, 3 heads of 24 dims over 2
TOWERS = [(64, 2, 4), (96, 12, 8), (72, 3, 2)]


def cpu_mesh(d, m):
    return pm.create_mesh((d, m), devices=[CPU] * (d * m))


def ulp_bf16(mag):
    return 2.0 ** (math.floor(math.log2(mag)) - 7)


def within_one_ulp(got, ref):
    got, ref = got.detach().float(), ref.detach().float()
    tol = ulp_bf16(ref.abs().max().item())
    err = (got - ref).abs().max().item()
    assert err <= tol, f"max err {err} > 1 bf16 ulp {tol}"


def close(got, want, tol):
    err = (got.detach().float() - want.detach().float()).abs().max().item()
    assert err <= tol, f"max err {err} > {tol}"


def _images(n=4, seed=1):
    return np.random.default_rng(seed).normal(size=(n, 32, 32, 3)).astype(np.float32)


def _tokens(n=4, seed=2, ctx=16, vocab=512):
    rng = np.random.default_rng(seed)
    t = np.zeros((n, ctx), np.int64)
    t[:, 0] = vocab - 2
    t[:, 1] = rng.integers(1, 100, n)
    t[:, 2] = rng.integers(1, 100, n)
    t[:, 3] = vocab - 1
    return t


def _jax_pair(width, heads, layers=1):
    """A JAX CLIP config and params at this vision width / head count, and
    the port's CLIP loaded from the same params."""
    import jax

    from debias_vision_lang_tpu.core import config as jc
    from debias_vision_lang_tpu.models.clip import init_clip_params as jinit
    from debias_vision_lang_torch.models.convert import params_from_jax
    from torch_port_config import port_config

    cfg = jc.CLIPConfig(
        name="tiny-tp-shapes",
        vision=jc.VisionConfig(kind="vit", image_size=32, patch_size=8, width=width,
                               layers=layers, heads=heads, embed_dim=32),
        text=jc.TextConfig(vocab_size=512, context_length=16, width=32, layers=layers,
                           heads=2, embed_dim=32))
    params = jinit(jax.random.key(width + heads), cfg)
    # move every leaf off its init (biases and LayerNorms included)
    rng = np.random.default_rng(width)
    params = jax.tree.map(
        lambda a: a + (rng.normal(size=a.shape) * 0.02).astype(np.asarray(a).dtype)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else a, params)
    tcfg = port_config(cfg)
    clip = CLIP(tcfg)
    clip.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tcfg))
    return cfg, params, clip.eval()


def _jax_mesh(m):
    import jax

    from debias_vision_lang_tpu.parallel.mesh import create_mesh

    return create_mesh((1, m), devices=jax.devices()[:m])


# ---------------------------------------------------------------------------
# The split contract: JAX's refusals, and only those
# ---------------------------------------------------------------------------


def _jax_refuses(d, f, m):
    """Does JAX's shard_clip_params refuse a one-layer tower of width d and
    hidden f over (1, m)?"""
    import jax.numpy as jnp

    from debias_vision_lang_tpu.parallel.mesh import shard_clip_params

    z = jnp.zeros
    rb = {"ln_1": {"scale": z((1, d)), "bias": z((1, d))},
          "attn": {"wqkv": z((1, d, 3 * d)), "bqkv": z((1, 3 * d)), "wo": z((1, d, d)),
                   "bo": z((1, d))},
          "ln_2": {"scale": z((1, d)), "bias": z((1, d))},
          "mlp": {"w1": z((1, d, f)), "b1": z((1, f)), "w2": z((1, f, d)), "b2": z((1, d))}}
    try:
        shard_clip_params({"visual": {"resblocks": rb}}, _jax_mesh(m))
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("d,heads,f,m", [
    (64, 2, 256, 4), (96, 12, 384, 8), (72, 3, 288, 2), (36, 3, 144, 8), (60, 5, 240, 8),
    (64, 8, 100, 8), (768, 12, 3072, 8), (200, 2, 808, 8), (63, 3, 252, 2), (72, 3, 288, 5),
    (48, 3, 192, 3), (64, 4, 256, 3), (1280, 16, 5120, 2), (32, 2, 128, 8)])
def test_check_split_refuses_where_jax_refuses(d, heads, f, m):
    refused = _jax_refuses(d, f, m)
    if refused:
        with pytest.raises(ValueError, match=rf"(D={d}|F={f}) .*% {m} != 0"):
            tpar.check_split(d, heads, f, m)
    else:
        tpar.check_split(d, heads, f, m)
    assert refused == bool(d % m or f % m)


@pytest.mark.parametrize("heads,m,groups", [
    (12, 8, [1, 2, 1, 2, 1, 2, 1, 2]), (2, 4, [0, 1, 0, 1]), (3, 2, [1, 2]), (12, 12, [1] * 12),
    (4, 16, [0, 0, 0, 1] * 4)])
def test_head_groups_cover_every_head_once(heads, m, groups):
    got = [tpar.head_group(heads, m, j) for j in range(m)]
    assert [hi - lo for lo, hi in got] == groups
    assert [h for lo, hi in got for h in range(lo, hi)] == list(range(heads))
    d = 8 * heads
    cols = torch.cat([tpar.head_columns(d, m, j, heads) for j in range(m)])
    assert sorted(cols.tolist()) == list(range(3 * d))


# ---------------------------------------------------------------------------
# Towers against JAX's sharded and unsharded forwards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width,heads,m", TOWERS)
def test_float32_towers_match_jax_sharded_and_unsharded(width, heads, m):
    import jax
    import jax.numpy as jnp

    from debias_vision_lang_tpu.models import clip as jclip
    from debias_vision_lang_tpu.parallel.mesh import shard_clip_params as jshard

    cfg, params, clip = _jax_pair(width, heads)
    imgs, toks = _images(), _tokens()

    @jax.jit
    def fwd(p, x, t):
        return jclip.forward(p, x, t, cfg, use_pallas=False)

    base, _ = fwd(params, jnp.asarray(imgs), jnp.asarray(toks.astype(np.int32)))
    sharded, _ = fwd(jshard(params, _jax_mesh(m)), jnp.asarray(imgs),
                     jnp.asarray(toks.astype(np.int32)))
    placed = pm.shard_clip_params(clip, cpu_mesh(1, m))
    assert isinstance(placed.visual.resblocks, tpar.TensorParallelBlocks)
    with torch.no_grad():
        got, _ = placed(torch.from_numpy(imgs), torch.from_numpy(toks))
        one, _ = clip(torch.from_numpy(imgs), torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(base), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(sharded), atol=1e-4)
    close(got, one, 1e-5)


@pytest.mark.parametrize("width,heads,m", TOWERS)
def test_int8_towers_match_jax_and_are_bit_equal_unsharded(width, heads, m):
    import jax.numpy as jnp

    from debias_vision_lang_tpu.models.loader import CLIP as JCLIP
    from debias_vision_lang_tpu.ops.quant import QuantizedCLIP as JQ

    cfg, params, clip = _jax_pair(width, heads)
    jq = JQ(JCLIP(params=params, cfg=cfg), quantize_text=True)
    imgs, toks = _images(8, seed=8), _tokens(8, seed=9)
    i_single = np.asarray(jq.encode_image(jnp.asarray(imgs), dtype=jnp.float32))
    t_single = np.asarray(jq.encode_text(jnp.asarray(toks.astype(np.int32)), dtype=jnp.float32))
    q = QuantizedCLIP(clip, quantize_text=True)
    q_tp = pm.shard_quantized_clip(q, cpu_mesh(1, m))
    assert isinstance(q_tp.visual_q.resblocks, tpar.TensorParallelQBlocks)
    x, t = torch.from_numpy(imgs), torch.from_numpy(toks)
    with torch.no_grad():
        i_tp = q_tp.encode_image(x, dtype=torch.float32)
        t_tp = q_tp.encode_text(t, dtype=torch.float32)
        assert torch.equal(i_tp, q.encode_image(x, dtype=torch.float32))
        assert torch.equal(t_tp, q.encode_text(t, dtype=torch.float32))
        # bfloat16: the split kernels' twins, bit-equal to K3 / K4's
        assert torch.equal(q_tp.encode_image(x, dtype=torch.bfloat16),
                           q.encode_image(x, dtype=torch.bfloat16))
        assert torch.equal(q_tp.encode_text(t, dtype=torch.bfloat16),
                           q.encode_text(t, dtype=torch.bfloat16))
    np.testing.assert_allclose(i_tp.numpy(), i_single, atol=1e-5)
    np.testing.assert_allclose(t_tp.numpy(), t_single, atol=1e-5)


def _block_np(rng, d, f):
    def rn(*shape, std=1.0):
        return torch.from_numpy((rng.normal(size=shape) * std).astype(np.float32))

    return {"ln_1": (1 + rn(d, std=0.1), rn(d, std=0.1)),
            "attn": (rn(d, 3 * d, std=d ** -0.5), rn(3 * d, std=0.1), rn(d, d, std=d ** -0.5),
                     rn(d, std=0.1)),
            "ln_2": (1 + rn(d, std=0.1), rn(d, std=0.1)),
            "mlp": (rn(d, f, std=(2 * d) ** -0.5), rn(f, std=0.1), rn(f, d, std=f ** -0.5),
                    rn(d, std=0.1))}


def _resblock(p):
    from debias_vision_lang_torch.models.layers import ResidualBlock

    d = p["ln_1"][0].shape[0]
    blk = ResidualBlock(d)
    sd = {"ln_1.scale": p["ln_1"][0], "ln_1.bias": p["ln_1"][1], "ln_2.scale": p["ln_2"][0],
          "ln_2.bias": p["ln_2"][1]}
    sd.update(zip(("attn.wqkv", "attn.bqkv", "attn.wo", "attn.bo"), p["attn"]))
    sd.update(zip(("mlp.w1", "mlp.b1", "mlp.w2", "mlp.b2"), p["mlp"]))
    blk.load_state_dict(sd)
    return blk


@pytest.mark.parametrize("d,heads,m", [*TOWERS, (64, 4, 16)])
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_split_block_within_one_ulp_of_k1_k2(d, heads, m, causal):
    p = _block_np(np.random.default_rng(d + m), d, 4 * d)
    tp = tpar.TensorParallelBlocks(torch.nn.ModuleList([_resblock(p)]), cpu_mesh(1, m), heads)
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(3, 13, d))
                         .astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        got = tp.block(0, x, route="fused", causal=causal)
        y = fb.attention_block_plain(x, *p["ln_1"], *p["attn"], heads=heads, causal=causal)
        want = fb.mlp_block_plain(y, *p["ln_2"], *p["mlp"])
    within_one_ulp(got, want)


def _tiny16():
    cfg = CLIPConfig(
        name="tiny-tp16",
        vision=VisionConfig(kind="vit", image_size=32, patch_size=8, width=64, layers=2,
                            heads=4, embed_dim=32),
        text=TextConfig(vocab_size=512, context_length=16, width=32, layers=2, heads=2,
                        embed_dim=32))
    clip = CLIP(cfg)
    clip.load_state_dict(init_clip_params(cfg, torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in clip.parameters():
            p.add_(torch.tensor(rng.normal(size=tuple(p.shape)) * 0.02, dtype=torch.float32))
    return clip.eval()


def test_sixteen_model_slots_match_unsharded():
    """m = 16 (past one reduce launch's 8 partials; 12 of the image tower's
    16 slots and 14 of the text tower's hold no head): float32 within 1e-5
    of the unsharded forward, int8 bit-equal at float32 and bfloat16."""
    clip = _tiny16()
    x, t = torch.from_numpy(_images()), torch.from_numpy(_tokens())
    placed = pm.shard_clip_params(clip, cpu_mesh(1, 16))
    q = QuantizedCLIP(clip, quantize_text=True)
    q_tp = pm.shard_quantized_clip(q, cpu_mesh(1, 16))
    assert len(placed.visual.resblocks[0].slots) == 16
    with torch.no_grad():
        got, _ = placed(x, t)
        want, _ = clip(x, t)
        close(got, want, 1e-5)
        for dt in (torch.float32, torch.bfloat16):
            assert torch.equal(q_tp.encode_image(x, dtype=dt), q.encode_image(x, dtype=dt))
            assert torch.equal(q_tp.encode_text(t, dtype=dt), q.encode_text(t, dtype=dt))


# ---------------------------------------------------------------------------
# The reduce's slot count, empty slots, the padded group layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 8, 9, 15, 16, 17, 40])
def test_one_reduce_sums_the_slots_in_order(n):
    """n slots' f32 partials (of magnitudes 1e-3 .. 1e3, so the order
    shows) in one reduce: summed in slot order and rounded as one sequential
    numpy f32 sum, then + bias + resid in each half's order, bit for bit."""
    fb.check_parts(n, "tp_reduce")
    rng = np.random.default_rng(n)
    parts = [(rng.normal(size=(3, 257)) * 10.0 ** rng.integers(-3, 4)).astype(np.float32)
             for _ in range(n)]
    bias = rng.normal(size=257).astype(np.float32)
    resid = rng.normal(size=(3, 257)).astype(np.float32)
    s = parts[0].copy()
    for p in parts[1:]:
        s = s + p
    for bias_first, want in ((False, resid + (s + bias)), (True, (resid + bias) + s)):
        got = fb.tp_reduce([torch.from_numpy(p) for p in parts], torch.from_numpy(bias),
                           torch.from_numpy(resid), bias_first=bias_first)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [0, 257, 1000])
def test_more_slots_than_one_reduce_takes_raise(n):
    """The reduce kernels hold TP_PARTS = 256 partials' pointers: the split
    refuses a model axis past it (JAX refuses a mesh past its device count),
    and the reduce entries refuse the partial count."""
    with pytest.raises(ValueError, match=r"1 to 256 slots"):
        fb.check_parts(n, "tp_reduce")
    if n:
        with pytest.raises(ValueError, match=f"{n} model slots"):
            tpar.check_split(64 * n, n, 256 * n, n)


def test_a_slot_without_a_head_runs_no_attention(monkeypatch):
    calls = {"heads": [], "cols": 0}
    real_heads, real_cols = fb.attention_block_heads, fb.mlp_block_cols

    def heads_spy(*a, heads, **k):
        calls["heads"].append(heads)
        return real_heads(*a, heads=heads, **k)

    def cols_spy(*a, **k):
        calls["cols"] += 1
        return real_cols(*a, **k)

    monkeypatch.setattr(fb, "attention_block_heads", heads_spy)
    monkeypatch.setattr(fb, "mlp_block_cols", cols_spy)
    p = _block_np(np.random.default_rng(3), 64, 256)
    tp = tpar.TensorParallelBlocks(torch.nn.ModuleList([_resblock(p)]), cpu_mesh(1, 4), 2)
    assert [s.g for s in tp[0].slots] == [0, 1, 0, 1]
    assert tuple(tp[0].slots[0].wqkv.shape) == (64, 0)
    x = torch.randn(2, 9, 64, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    with torch.no_grad():
        tp.block(0, x, route="fused")
    assert calls == {"heads": [1, 1], "cols": 4}


@pytest.mark.parametrize("d,hd,g", [(64, 32, 1), (96, 8, 2), (72, 24, 2), (200, 100, 1),
                                    (144, 72, 2), (1280, 80, 8)])
def test_group_layout_is_the_groups_partial(d, hd, g):
    """The kernels' data flow of a head group on ``group_plan``'s padded
    layout (attn_operands with no bo): LayerNorm to dk, the QKV product at
    nqkv, the core over hdp lanes at the true head dim's scale, the out
    product's first D columns; equal to the unpadded group's partial but
    for the order of f32 sums (within one bf16 ulp of its largest
    magnitude: qkv rounds to bf16 after a sum in another order; a lane out
    of place would move it by its whole size)."""
    rng = np.random.default_rng(d + g)
    x = torch.from_numpy(rng.normal(size=(2, 11, d)).astype(np.float32)).to(torch.bfloat16)
    ln_s, ln_b = (torch.from_numpy(rng.normal(size=d).astype(np.float32)) for _ in range(2))
    wqkv = torch.from_numpy((rng.normal(size=(d, 3 * g * hd)) * d ** -0.5).astype(np.float32))
    bqkv = torch.from_numpy((rng.normal(size=3 * g * hd) * 0.1).astype(np.float32))
    wo = torch.from_numpy((rng.normal(size=(g * hd, d)) * d ** -0.5).astype(np.float32))
    plan = fb.group_plan(d, hd, g)
    assert plan.identity == (hd == 64 and d % 128 == 0)
    wq_p, bq_p, wo_p = fb.attn_operands(wqkv, bqkv, wo, None, plan)
    assert wq_p.shape == (plan.nqkv, plan.dk) and wo_p.shape == (plan.no, plan.da)
    xn = fb.pad_cols(fb.ln_f32(x, ln_s, ln_b), plan.dk)
    qkv = (fb._dot_f32(xn, wq_p.t()) + bq_p.float()).to(x.dtype)[..., :3 * plan.da]
    o = fb.attention_core(qkv, g, False, scale=plan.scale)
    got = fb._dot_f32(o, wo_p.t())[..., :d]
    want = fb.attention_block_heads_plain(x, ln_s, ln_b, wqkv, bqkv, wo, heads=g)
    pad = torch.ones(plan.da, dtype=torch.bool)
    pad[plan.head_lanes()] = False
    assert bool((o[..., pad] == 0).all())  # P @ 0 in every padded lane
    within_one_ulp(got, want)


@pytest.mark.parametrize("kind,d,n,k", [("attn", 200, 200, 100), ("attn", 144, 144, 72),
                                        ("mlp", 200, 200, 404), ("mlp", 72, 72, 144)])
def test_row_parallel_product_on_padded_rows_is_exact(kind, d, n, k):
    """``rows_q_partial``'s card layout: a slot's rows padded by its plan
    and the weight's rows placed at the plan's lanes give the unpadded
    int32 partial exactly (zero lanes: the same amax, zero codes)."""
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.normal(size=(3, 5, k)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-127, 128, size=(k, n)).astype(np.int8))
    amax = fbq.row_amax(a) * 1.5  # another slot's larger amax
    plan = fb.group_plan(d, k, 1) if kind == "attn" else fb.mlp_plan(d, k)
    lanes = plan.head_lanes() if kind == "attn" else plan.hidden_columns()
    width = plan.da if kind == "attn" else plan.fp
    a_p = torch.zeros(3, 5, width)
    a_p[..., lanes] = a
    wt_p = fb.place(wq.t(), (fb.round_up(n, 128), width), cols=lanes)
    got, aq, _ = fbq.rows_q_partial_plain(a_p, [amax], wt_p.t())
    want, _, _ = fbq.rows_q_partial_plain(a, [amax], wq)
    assert torch.equal(got[..., :n], want)
    assert bool((aq[..., lanes] == aq[..., lanes]).all()) and int(aq.abs().sum()) == int(
        aq[..., lanes].abs().sum())


# ---------------------------------------------------------------------------
# enable_debug_nans on the port's own threads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("on", [True, False])
def test_debug_nans_reach_the_client_from_the_batcher_worker(on):
    from debias_vision_lang_torch.serve.batcher import MicroBatcher
    from debias_vision_lang_torch.serve.engine import InferenceEngine
    from debias_vision_lang_torch.utils.observability import enable_debug_nans

    clip = _tiny16()
    with torch.no_grad():
        clip.visual.resblocks[0].mlp.b1[3] = float("nan")  # a NaN in a CPU twin's hidden
    engine = InferenceEngine(clip, None, max_batch=4, compute_dtype="bfloat16", device="cpu")
    batcher = MicroBatcher(engine.dispatch_image_arrays, finalize=engine.fetch, max_batch=4,
                           max_wait_ms=1.0, name="nan-test")
    img = np.random.default_rng(0).integers(0, 255, size=(32, 32, 3), dtype=np.uint8)
    enable_debug_nans(on)
    try:
        fut = batcher.submit(img)
        if on:
            with pytest.raises(FloatingPointError, match="NaN in the output of"):
                fut.result(timeout=120)
        else:
            assert np.isnan(fut.result(timeout=120)).all()
    finally:
        enable_debug_nans(False)
        batcher.close()


# ---------------------------------------------------------------------------
# CUDA: the split entries off the registry widths, uneven groups, 16 slots
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled with nvcc for sm_90a "
                    "and have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_mesh(dev, m):
    return pm.create_mesh((1, m), devices=[dev] * m)


@pytest.mark.cuda
@pytest.mark.parametrize("d,heads,m,s", [(768, 12, 8, 197), (96, 12, 8, 17), (64, 2, 4, 77),
                                         (144, 2, 2, 77), (200, 2, 4, 50), (1280, 16, 2, 65),
                                         (64, 4, 16, 33)])
def test_cuda_split_block_off_the_registry_widths(cuda, d, heads, m, s):
    """bfloat16: one block through the split kernels within one bf16 ulp of
    K1 / K2's twins, one head entry launch per slot holding a head, one
    column entry per slot, one reduce per half; int8: the
    split block bit-equal to K3 / K4 on the card."""
    p = _block_np(np.random.default_rng(d + m), d, 4 * d)
    blk = _resblock(p).to(cuda)
    tp = tpar.TensorParallelBlocks(torch.nn.ModuleList([blk]), _card_mesh(cuda, m), heads)
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(3, s, d))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    fb.reset_launches()
    with torch.no_grad():
        got = tp.block(0, x, route="fused")
    torch.cuda.synchronize()
    busy = sum(1 for j in range(m) if tpar.head_group(heads, m, j)[0]
               != tpar.head_group(heads, m, j)[1])
    assert fb.TP_LAUNCHES["attention_block_heads"] == busy
    assert fb.TP_LAUNCHES["mlp_block_cols"] == m
    assert fb.TP_LAUNCHES["tp_reduce"] == 2
    xc = x.cpu()
    y = fb.attention_block_plain(xc, *p["ln_1"], *p["attn"], heads=heads)
    within_one_ulp(got.cpu(), fb.mlp_block_plain(y, *p["ln_2"], *p["mlp"]))
    # int8: the split block bit-equal to K3 / K4 on the card
    from debias_vision_lang_torch.ops.quant import quantize_resblocks

    qb = quantize_resblocks(torch.nn.ModuleList([blk]))
    tq = tpar.TensorParallelQBlocks(qb, _card_mesh(cuda, m), heads)
    fbq.reset_launches()
    with torch.no_grad():
        got_q = tq.block(0, x, route="fused")
        want_q = fbq.fused_resblock_q(qb[0], x, heads)
    torch.cuda.synchronize()
    assert torch.equal(got_q, want_q)
    assert fbq.TP_LAUNCHES["attention_block_q_heads"] == busy
    assert fbq.TP_LAUNCHES["mlp_block_q_cols"] == m
    assert fbq.TP_LAUNCHES["tp_reduce_q"] == 2
