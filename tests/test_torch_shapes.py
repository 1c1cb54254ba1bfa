"""K1-K4 at the shapes the JAX kernels take and the card's first kernels
refused: head dims other than 64, widths off the GEMM tiles, any F-split
(debias_vision_lang_torch/ops/fused_block.py ``attn_plan`` / ``mlp_plan``,
the padded operand layout the CUDA kernels read).

CPU only; the same numpy inputs go through both packages:
  * JAX's ``attention_block`` / ``mlp_block`` / ``attention_block_q`` /
    ``mlp_block_q`` in interpret mode against the port's twins at ragged
    shapes (D, H, F) = (144, 2, 344), (160, 2, 320), (208, 2, 416) and
    (200, 2, 808) (head dims 72, 80, 104, 100; D = 200 off every tile),
    S = 77, non-causal and causal, the MLPs unsplit and at fb = F / 4:
    float32 at 2e-5, bfloat16 within one bf16 ulp; the int8 blocks stage
    by stage against the codes JAX's kernel quantizes (recorded through its
    ``_quant_rows``): codes under chip_smoke.py's phase-6 bars, the last
    product on JAX's own codes at 1e-4 (float32) or one bf16 ulp;
  * each operand plan: the twin run on the padded operands at the padded
    widths, then cropped (``attention_block_padded`` and its kin, the
    kernels' data flow), against the twin on the original operands: int8
    codes and outputs bit for bit, bf16 within one ulp; the plan is the
    identity at the registry archs' widths (ViT-B/16, ViT-L/14, RN50x4's
    text), where the kernels read the parameters' plain copies;
  * 2-layer towers from hand-built configurations at head dims 72 and 80,
    bf16 and int8, the port (its twins) against JAX on the CPU: bf16 at the
    ROADMAP's tower bar (cosine >= 0.99994, against JAX's bf16 and float32
    towers); int8 at phase 17's bar (mean cosine error to float32 at most
    1.1 times JAX's own int8 tower's: JAX's int8 tower itself stays below
    the ROADMAP's 0.99990 on these random towers).

    python -m pytest tests/test_torch_shapes.py -q -p no:randomly

On the card, ``chip_smoke.py`` phase 27 (``benchmarks_torch/shapes_phase.py``
alone) runs the kernels at public models' widths.
"""

import math

import numpy as np
import pytest
import torch

from debias_vision_lang_torch.ops import fused_block as fb
from debias_vision_lang_torch.ops import fused_block_q as fbq
from debias_vision_lang_torch.ops import quant

torch.set_num_threads(1)

SHAPES = [(144, 2, 344), (160, 2, 320), (208, 2, 416), (200, 2, 808)]
IDS = [f"D{d}-H{h}-F{f}" for d, h, f in SHAPES]
B, S = 2, 77


def _layer(d, f, seed):
    rng = np.random.default_rng(seed)

    def rn(*shape, std=1.0):
        return (rng.normal(size=shape) * std).astype(np.float32)

    attn = (1 + rn(d, std=0.1), rn(d, std=0.1), rn(d, 3 * d, std=d ** -0.5), rn(3 * d, std=0.1),
            rn(d, d, std=d ** -0.5), rn(d, std=0.1))
    mlp = (1 + rn(d, std=0.1), rn(d, std=0.1), rn(d, f, std=(2 * d) ** -0.5), rn(f, std=0.1),
           rn(f, d, std=f ** -0.5), rn(d, std=0.1))
    return attn, mlp


_CACHE = {}


def _case(shape):
    """(x, bf16 attention and MLP tensors, int8 attention and MLP args as
    numpy) for one shape, made once."""
    if shape not in _CACHE:
        d, h, f = shape
        attn, mlp = _layer(d, f, seed=d)
        qa = [quant.quantize_weight(torch.from_numpy(w)) for w in (attn[2], attn[4])]
        qm = [quant.quantize_weight(torch.from_numpy(w)) for w in (mlp[2], mlp[4])]
        qattn = (attn[0], attn[1], qa[0]["q"].numpy(), qa[0]["scale"].numpy(), attn[3],
                 qa[1]["q"].numpy(), qa[1]["scale"].numpy(), attn[5])
        qmlp = (mlp[0], mlp[1], qm[0]["q"].numpy(), qm[0]["scale"].numpy(), mlp[3],
                qm[1]["q"].numpy(), qm[1]["scale"].numpy(), mlp[5])
        x = np.random.default_rng(d + 1).normal(size=(B, S, d)).astype(np.float32)
        _CACHE[shape] = x, attn, mlp, qattn, qmlp
    return _CACHE[shape]


def _jnp(a, dtype=None):
    import jax.numpy as jnp

    out = jnp.asarray(a)
    return out if dtype is None else out.astype(dtype)


def _t(a, dtype=torch.float32):
    a = np.asarray(a)
    return torch.from_numpy(a) if a.dtype == np.int8 else torch.from_numpy(
        a.astype(np.float32)).to(dtype)


def _np32(t):
    return np.asarray(t.detach().float() if torch.is_tensor(t) else t, np.float32)


def _within_one_ulp(got, ref):
    got, ref = _np32(got), _np32(ref)
    ulp = 2.0 ** (math.floor(math.log2(np.abs(ref).max())) - 7)
    err = np.abs(got - ref).max()
    assert err <= ulp, f"max err {err} > 1 bf16 ulp {ulp}"


def _dtypes(name):
    import jax.numpy as jnp

    return {"float32": (jnp.float32, torch.float32),
            "bfloat16": (jnp.bfloat16, torch.bfloat16)}[name]


# ---------------------------------------------------------------------------
# 1. The JAX kernels (interpret mode) against the port's twins
# ---------------------------------------------------------------------------


class TestTwinsAgainstPallas:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("shape", SHAPES, ids=IDS)
    def test_attention(self, shape, causal, dtype):
        from debias_vision_lang_tpu.ops.fused_block import attention_block

        x, attn, _, _, _ = _case(shape)
        jdt, tdt = _dtypes(dtype)
        ref = attention_block(_jnp(x, jdt), *map(_jnp, attn), heads=shape[1], causal=causal,
                              interpret=True)
        got = fb.attention_block(_t(x, tdt), *map(_t, attn), heads=shape[1], causal=causal)
        if dtype == "float32":
            np.testing.assert_allclose(_np32(got), _np32(ref), atol=2e-5)
        else:
            _within_one_ulp(got, ref)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("split", [1, 4])
    @pytest.mark.parametrize("shape", SHAPES, ids=IDS)
    def test_mlp(self, shape, split, dtype):
        """JAX's F-split accumulates the tiles' down products; the twin is
        the unsplit function (the same sum in another order)."""
        from debias_vision_lang_tpu.ops.fused_block import mlp_block

        x, _, mlp, _, _ = _case(shape)
        jdt, tdt = _dtypes(dtype)
        ref = mlp_block(_jnp(x, jdt), *map(_jnp, mlp), act_kind="gelu", bb=1,
                        fb=shape[2] // split, interpret=True)
        got = fb.mlp_block(_t(x, tdt), *map(_t, mlp), act_kind="gelu")
        if dtype == "float32":
            np.testing.assert_allclose(_np32(got), _np32(ref), atol=2e-5)
        else:
            _within_one_ulp(got, ref)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("shape", SHAPES, ids=IDS)
    def test_attention_q(self, shape, causal, dtype, monkeypatch):
        """Stage by stage against the codes JAX's kernel quantizes
        (recorded): the twin's x codes, the twin's attention codes from
        JAX's x codes, each under phase 6's bars (torch's LayerNorm and
        core round otherwise than XLA's, which flips a few codes); the
        twin's last step on JAX's attention codes at the dtype's bar; the
        whole twin at that bar where every code agrees."""
        from debias_vision_lang_tpu.ops import fused_block_q as J

        x, _, _, qattn, _ = _case(shape)
        jdt, tdt = _dtypes(dtype)
        ref, rec = _recorded(monkeypatch, J.attention_block_q, _jnp(x, jdt), *map(_jnp, qattn),
                             heads=shape[1], causal=causal, bb=1, interpret=True)
        sk = {}
        xt, a = _t(x, tdt), [_t(t) for t in qattn]
        got = fbq.attention_block_q(xt, *a, heads=shape[1], causal=causal, scratch=sk)
        jx, ja = _stack(_site(rec, 0)), _stack(_site(rec, 1))
        _codes_within(sk["xq"], jx[0], 1)
        qkv = (fbq.dot_q(jx[0], jx[1], a[2], a[3]) + a[4]).to(tdt)
        aq, _ = fbq.quant_rows(fb.attention_core(qkv, shape[1], causal).float())
        _codes_within(aq, ja[0], 2)
        own = (xt.float() + (fbq.dot_q(ja[0], ja[1], a[5], a[6]) + a[7])).to(tdt)
        _close(own, ref, dtype)
        if torch.equal(sk["xq"], jx[0]) and torch.equal(sk["aq"], ja[0]):
            _close(got, ref, dtype)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("split", [1, 4])
    @pytest.mark.parametrize("shape", SHAPES, ids=IDS)
    def test_mlp_q(self, shape, split, dtype, monkeypatch):
        """At fb = F / 4 both sides quantize each chunk of a hidden row on
        its own (JAX's F-split, the twin's ``fsplit_down``).  Stage by stage
        as ``test_attention_q``: the twin's x codes, its hidden codes from
        JAX's x codes, its last step on JAX's hidden codes, the whole twin
        where every code agrees."""
        from debias_vision_lang_tpu.ops import fused_block_q as J

        x, _, _, _, qmlp = _case(shape)
        jdt, tdt = _dtypes(dtype)
        d, f = shape[0], shape[2]
        fbv = f // split
        ref, rec = _recorded(monkeypatch, J.mlp_block_q, _jnp(x, jdt), *map(_jnp, qmlp),
                             act_kind="gelu", bb=1, fb=fbv, interpret=True, grid_axes=2)
        sk = {}
        xt, w = _t(x, tdt), [_t(t) for t in qmlp]
        got = fbq.mlp_block_q(xt, *w, act_kind="gelu", fb=fbv, scratch=sk)
        # grid (image, F-tile): x (the same at every tile) and the tile's hidden
        jx = _stack(_site(rec, 0)[::split])
        hid = _site(rec, 1)
        jh = [torch.from_numpy(np.stack([q for q, _ in hid])),
              torch.from_numpy(np.stack([s for _, s in hid]))]
        hq = jh[0].reshape(B, split, S, fbv).transpose(1, 2)
        hs = jh[1].reshape(B, split, S, 1).transpose(1, 2)
        _codes_within(sk["xq"], jx[0], 1)
        h = fb._act(fbq.dot_q(jx[0], jx[1], w[2], w[3]) + w[4], "gelu")
        own_hq, _ = fbq.quant_rows(h.reshape(B, S, split, fbv))
        _codes_within(own_hq, hq, 1)
        part = None
        for c in range(split):
            p = fbq.dot_q(hq[:, :, c], hs[:, :, c], w[5][c * fbv:(c + 1) * fbv], w[6])
            part = p if part is None else part + p
        _close(((xt.float() + w[7]) + part).to(tdt), ref, dtype)
        if torch.equal(sk["xq"], jx[0]) and torch.equal(sk["hq"].reshape(hq.shape), hq):
            _close(got, ref, dtype)


CODE_SHARE_MAX = 1e-3  # chip_smoke.py's phase-6 bar: the share of codes off the reference's


def _recorded(monkeypatch, fn, *args, grid_axes=1, **kw):
    """``fn`` (a jitted JAX int8 block) run un-jitted with its kernel's
    ``_quant_rows`` recording every (codes, scales) it returns: {(call
    site in the kernel body, grid position): (q, s)} (the callbacks run
    in no set order, so each carries both)."""
    import jax
    from jax.experimental import pallas as pl

    from debias_vision_lang_tpu.ops import fused_block_q as J

    rec, sites, orig = {}, [], J._quant_rows

    def quant_rows(v):
        q, s = orig(v)
        site = len(sites)  # traced once per call site: 0 x, 1 the attention / hidden rows
        sites.append(site)
        pid = tuple(pl.program_id(a) for a in range(grid_axes))

        def keep(q, s, *pid):
            rec[(site, tuple(int(i) for i in pid))] = (np.asarray(q), np.asarray(s))

        jax.debug.callback(keep, q, s, *pid)
        return q, s

    monkeypatch.setattr(J, "_quant_rows", quant_rows)
    out = fn.__wrapped__(*args, **kw)
    jax.effects_barrier()
    return out, rec


def _site(rec, site):
    """One call site's recordings in grid order."""
    return [rec[k] for k in sorted(k for k in rec if k[0] == site)]


def _stack(pairs):
    """Per-image recordings [1, S, n] -> (codes [B, S, n], scales [B, S, 1])."""
    return (torch.from_numpy(np.concatenate([q for q, _ in pairs])),
            torch.from_numpy(np.concatenate([s for _, s in pairs]).astype(np.float32)))


def _codes_within(got, want, worst):
    diff = (got.int() - want.int()).abs()
    assert diff.max().item() <= worst, f"codes off by {diff.max().item()}"
    share = diff.ne(0).float().mean().item()
    assert share <= CODE_SHARE_MAX, f"{share} of the codes differ"


def _close(got, ref, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(_np32(got), _np32(ref), atol=1e-4)
    else:
        _within_one_ulp(got, ref)


# ---------------------------------------------------------------------------
# 2. The operand plans: the padded layout computes the unpadded function
# ---------------------------------------------------------------------------


class TestOperandPlans:
    @pytest.mark.parametrize("shape", SHAPES, ids=IDS)
    def test_plan_geometry(self, shape):
        d, h, f = shape
        p, m = fb.attn_plan(d, h), fb.mlp_plan(d, f, f // 4)
        hd = d // h
        assert (p.hd, p.hdp, p.da) == (hd, 64 * math.ceil(hd / 64), h * p.hdp)
        assert p.dk % 64 == 0 and p.dk - d < 64 and p.nqkv % 128 == 0 and p.no % 128 == 0
        assert p.nqkv >= 3 * p.da and p.no - d < 128
        assert not p.identity and p.scale == 1.0 / math.sqrt(hd)
        assert m.k == 4 and m.fbp % 128 == 0 and m.fbp - m.fb < 128 and m.fp == 4 * m.fbp
        cols = p.qkv_columns()
        assert cols.unique().numel() == 3 * d and int(cols.max()) < 3 * p.da
        hid = m.hidden_columns()
        assert hid.unique().numel() == f and int(hid.max()) < m.fp

    @pytest.mark.parametrize("d,heads,f", [(768, 12, 3072), (1024, 16, 4096), (640, 10, 2560),
                                           (512, 8, 2048)])
    def test_identity_at_the_registry_widths(self, d, heads, f):
        """ViT-B/16, ViT-L/14, RN50x4's text and the text towers: no
        padding, and the kernels read the plain K-major copies (the same
        objects as before the plans, no extra copy)."""
        p, m = fb.attn_plan(d, heads), fb.mlp_plan(d, f)
        assert p.identity and m.identity
        assert (p.dk, p.da, p.nqkv, p.no, m.fp) == (d, d, 3 * d, d, f)
        cpu = torch.device("cpu")
        wqkv, bqkv, wo, bo = (torch.randn(d, 3 * d), torch.randn(3 * d), torch.randn(d, d),
                              torch.randn(d))
        ops = fb._attn_kernel_ops(wqkv, bqkv, wo, bo, p, cpu)
        assert ops[0] is fb._kmajor(wqkv, (d, 3 * d), "wqkv", cpu)
        assert ops[2] is fb._kmajor(wo, (d, d), "wo", cpu)
        assert ops[1] is bqkv and ops[3] is bo

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("shape", SHAPES, ids=IDS)
    def test_attention_bf16_padded(self, shape, causal):
        d, h, _ = shape
        x, attn, _, _, _ = _case(shape)
        p = fb.attn_plan(d, h)
        xb, a = _t(x, torch.bfloat16), [_t(t) for t in attn]
        ops = fb.attn_operands(*a[2:], p)
        assert ops[0].shape == (p.nqkv, p.dk) and ops[2].shape == (p.no, p.da)
        got = fb.attention_block_padded(xb, a[0], a[1], *ops, plan=p, causal=causal)
        _within_one_ulp(got, fb.attention_block_plain(xb, *a, heads=h, causal=causal))

    @pytest.mark.parametrize("split", [1, 4])
    @pytest.mark.parametrize("shape", SHAPES, ids=IDS)
    def test_mlp_bf16_padded(self, shape, split):
        d, _, f = shape
        x, _, mlp, _, _ = _case(shape)
        m = fb.mlp_plan(d, f, f // split)
        xb, w = _t(x, torch.bfloat16), [_t(t) for t in mlp]
        ops = fb.mlp_operands(*w[2:], m)
        got = fb.mlp_block_padded(xb, w[0], w[1], *ops, plan=m, act_kind="gelu")
        _within_one_ulp(got, fb.mlp_block_plain(xb, *w, act_kind="gelu"))

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("shape", SHAPES, ids=IDS)
    def test_attention_q_padded_codes_bit_for_bit(self, shape, causal):
        d, h, _ = shape
        x, _, _, qattn, _ = _case(shape)
        p = fb.attn_plan(d, h)
        xb, a = _t(x, torch.bfloat16), [_t(t) for t in qattn]
        qt = [a[2].t().contiguous(), a[5].t().contiguous()]
        ops = fbq.q_attn_operands(qt[0], a[3], a[4], qt[1], a[6], a[7], p)
        sk, sr = {}, {}
        got = fbq.attention_block_q_padded(xb, a[0], a[1], *ops, plan=p, causal=causal,
                                           scratch=sk)
        ref = fbq.attention_block_q_plain(xb, *a, heads=h, causal=causal, scratch=sr)
        assert torch.equal(got, ref)
        assert torch.equal(sk["xq"][..., :d], sr["xq"]) and not sk["xq"][..., d:].any()
        assert torch.equal(p.crop_heads(sk["aq"]), sr["aq"])
        assert torch.equal(sk["xs"], sr["xs"]) and torch.equal(sk["as"], sr["as"])
        pad = torch.ones(p.da, dtype=torch.bool)
        pad[p.head_lanes()] = False
        assert not sk["aq"][..., pad].any()

    @pytest.mark.parametrize("split", [1, 4])
    @pytest.mark.parametrize("shape", SHAPES, ids=IDS)
    def test_mlp_q_padded_codes_bit_for_bit(self, shape, split):
        d, _, f = shape
        x, _, _, _, qmlp = _case(shape)
        fbv = f // split
        m = fb.mlp_plan(d, f, fbv)
        xb, w = _t(x, torch.bfloat16), [_t(t) for t in qmlp]
        ops = fbq.q_mlp_operands(w[2].t().contiguous(), w[3], w[4], w[5].t().contiguous(),
                                 w[6], w[7], m)
        sk, sr = {}, {}
        got = fbq.mlp_block_q_padded(xb, w[0], w[1], *ops, plan=m, act_kind="gelu", scratch=sk)
        ref = fbq.mlp_block_q_plain(xb, *w, act_kind="gelu", fb=None if split == 1 else fbv,
                                    scratch=sr)
        assert torch.equal(got, ref)
        hq = m.crop_hidden(sk["hq"].reshape(B, S, -1))
        assert torch.equal(hq.reshape(sr["hq"].shape), sr["hq"])
        assert torch.equal(sk["hs"].reshape(sr["hs"].shape), sr["hs"])


# ---------------------------------------------------------------------------
# 3. Towers at head dims 72 and 80, the port against JAX on the CPU
# ---------------------------------------------------------------------------


BF16_TOWER_COS = 0.99994  # ROADMAP's bf16 tower bar
INT8_ERR_RATIO = 1.1  # chip_smoke.py's phase-17 bar for an int8 tower on random weights


def _tower_pair(width, heads):
    import jax
    import jax.numpy as jnp

    from debias_vision_lang_tpu.core.config import CLIPConfig, TextConfig, VisionConfig
    from debias_vision_lang_torch.models import clip as tclip
    from debias_vision_lang_torch.models.convert import params_from_jax, to_jax_tree
    from torch_port_config import port_config

    cfg = CLIPConfig(
        name=f"tiny-hd{width // heads}",
        vision=VisionConfig(kind="vit", image_size=32, patch_size=8, width=width, layers=2,
                            heads=heads, embed_dim=32),
        text=TextConfig(vocab_size=512, context_length=16, width=32, layers=1, heads=2,
                        embed_dim=32))
    tcfg = port_config(cfg)
    np_params = jax.tree.map(
        lambda a: np.asarray(a, np.float32),
        to_jax_tree(tclip.init_clip_params(tcfg, torch.Generator().manual_seed(width))))
    model = tclip.CLIP(tcfg)
    model.load_state_dict(params_from_jax(np_params, tcfg))
    return jax.tree.map(jnp.asarray, np_params), cfg, model


def _cos_rows(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("rung", ["bfloat16", "int8"])
@pytest.mark.parametrize("width,heads", [(144, 2), (160, 2)], ids=["hd72", "hd80"])
def test_tower_against_jax(width, heads, rung):
    """Every block of the port's tower through the fused entry points (the
    twins on the CPU: the kernels' function, at head dim 72 or 80) against
    JAX's tower (its CPU route) on the same weights and 8 images.  bf16:
    per-row cosine >= 0.99994 against JAX's bf16 tower and against its
    float32 one.  int8: JAX's own int8 tower stays below ROADMAP's 0.99990
    against float32 on these random towers (0.99986 at head dim 80), so the
    port's int8 tower is held to it: its mean cosine error to JAX's float32
    tower at most 1.1 times JAX's int8 tower's."""
    import jax.numpy as jnp

    from debias_vision_lang_tpu.models.loader import CLIP as JCLIP
    from debias_vision_lang_tpu.ops import quant as jquant

    jp, cfg, model = _tower_pair(width, heads)
    x = np.random.default_rng(7).normal(size=(8, 32, 32, 3)).astype(np.float32)
    jm = JCLIP(params=jp, cfg=cfg)
    ref32 = np.asarray(jm.encode_image(jnp.asarray(x), dtype=jnp.float32), np.float32)
    if rung == "bfloat16":
        want = np.asarray(jm.encode_image(jnp.asarray(x), dtype=jnp.bfloat16), np.float32)
        got = model.encode_image(torch.from_numpy(x), dtype=torch.bfloat16)
        assert got.dtype == torch.bfloat16
        for ref in (want, ref32):
            cos = _cos_rows(_np32(got), ref)
            assert cos.min() >= BF16_TOWER_COS, f"cosine {cos.min()} < {BF16_TOWER_COS}"
    else:
        want = np.asarray(jquant.QuantizedCLIP(jm).encode_image(jnp.asarray(x)), np.float32)
        got = quant.QuantizedCLIP(model).encode_image(torch.from_numpy(x))
        assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
        err_port = 1 - _cos_rows(_np32(got), ref32).mean()
        err_jax = 1 - _cos_rows(want, ref32).mean()
        assert err_port <= INT8_ERR_RATIO * err_jax, (
            f"the port's int8 tower's mean cosine error {err_port} > {INT8_ERR_RATIO} x JAX's "
            f"{err_jax}")
