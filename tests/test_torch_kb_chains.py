"""The chain-schedule KB sites of ``benchmarks/`` (ROADMAP queue 2 (b)): the
TPU issue orders of K1, K3 and K4, each held on the CPU to the port's twin
of the function it computes.

Each body is a closure or a partial that its script's ``main()`` hands to
``pallas_call``: captured by ``kb_helpers.capture`` (CH_BATCH / ILP_BATCH
4, CH_STEPS / ILP_STEPS 1; one capture per script, since q_ilp3.py and
q_ilp4.py both name their body ``kern``) and run through the real
``pallas_call`` in interpret mode on one block of its own batch items
(``bb``, the leading dimension of the script's first BlockSpec) at the
scripts' width, ViT-B/16 (S=197, D=768, H=12, F=3072), at the full-width
bars of ``tests/kb_helpers.py``:

  bf16_chains.py:101   make_attn_chains     attn_chains_kernel (bb=2)  K1
  attn_batched.py:84   tower(kern, bb)      _attn_q_kernel (bb=2),     K3
                                            hybrid_kernel (bb=4)
  q_ilp.py:169         bb2_call             mlp_bb2_kernel (bb=2)      K4
  q_ilp2.py:106        attn_bb2_call        attn_bb2_kernel (bb=2)     K3
  q_ilp2.py:175        mlp_bb4_call         mlp_bb4_kernel (bb=4)      K4
  q_ilp3.py:106        make_call(bb)        kern (bb=2, 4)             K3
  q_ilp4.py:125        make_call(bb)        kern (bb=2, 4)             attention_block_q_postdiv

At float32 the attention bodies are held within one bf16 ulp of their
twin and bit for bit to a JAX reference of the same function on the same
input: the K3 sites to JAX's ``attention_block_q`` (bb=1, interpret mode),
q_ilp4.py's bodies (bb=2 and 4, on the same 4 images) to each other.  PR 17's per-row atol 1e-4 does
not hold for them at every input: XLA's fused LayerNorm rounds about 44%
of x's normalised values otherwise than torch's in the last bit, which
moves about 40% of the rows' int8 scales (and, now and then, a code);
each such row is a key and value row of its image, so every query row of
the image moves, and an attention code flipped there moves its row past
1e-4 (up to 152 of an image's 197 rows at one of these inputs).  The MLP
and bf16 K1 sites keep the per-row bar.

q_ilp4.py's head-pair packed kernel is not K3's function: it rounds the
unnormalised exponentials for P V and divides the output by the row sum
after it (``o / l``), where K3 normalises and rounds the probabilities
first.  It is held to its own twin, ``attention_block_q_postdiv_plain``
(K3's quantizer with KB (a) 4's core), and the CUDA test holds its kernel
to that twin on the card (marker ``cuda``).

    python -m pytest tests/test_torch_kb_chains.py -q -p no:randomly
"""

import numpy as np
import pytest
import torch

from debias_vision_lang_torch.ops import fused_block as fb
from debias_vision_lang_torch.ops import fused_block_q as fbq
from kb_helpers import (_jnp, _layer, _pallas_ops, _t, _ulp, _x, capture, check, interpret,
                        within_one_ulp)

torch.set_num_threads(1)

S, D, H = 197, 768, 12  # ViT-B/16: the closures' width
SCRIPTS = ("bf16_chains", "attn_batched", "q_ilp", "q_ilp2", "q_ilp3", "q_ilp4")
ENV = {"CH_BATCH": 4, "CH_STEPS": 1, "ILP_BATCH": 4, "ILP_STEPS": 1}
# (script, kernel function name, index among its captures, the port's counterpart)
SITES = [("bf16_chains", "attn_chains_kernel", 0, "k1"),
         ("attn_batched", "_attn_q_kernel", 0, "k3"),
         ("attn_batched", "hybrid_kernel", 0, "k3"),
         ("q_ilp", "mlp_bb2_kernel", 0, "k4"),
         ("q_ilp2", "attn_bb2_kernel", 0, "k3"),
         ("q_ilp2", "mlp_bb4_kernel", 0, "k4"),
         ("q_ilp3", "kern", 0, "k3"),
         ("q_ilp3", "kern", 1, "k3"),
         ("q_ilp4", "kern", 0, "postdiv"),
         ("q_ilp4", "kern", 1, "postdiv")]


@pytest.fixture(scope="module")
def captured():
    return {name: capture((name,), ENV) for name in SCRIPTS}


@pytest.fixture(scope="module")
def blocks():
    """An int8 block (numpy) and a bf16 block's attention tensors (f32)."""
    rng = np.random.default_rng(40)

    def rn(*shape, std=1.0):
        return (rng.normal(size=shape) * std).astype(np.float32)

    bf16 = (1 + rn(D, std=0.1), rn(D, std=0.1), rn(D, 3 * D, std=D ** -0.5),
            rn(3 * D, std=0.1), rn(D, D, std=D ** -0.5), rn(D, std=0.1))
    return _layer(D, seed=41), bf16


def test_every_body_was_captured(captured):
    got = {(script, name, i, bb) for script, c in captured.items()
           for name, bbs in c.bb.items() for i, bb in enumerate(bbs)}
    want = {("bf16_chains", "attn_chains_kernel", 0, 2), ("attn_batched", "_attn_q_kernel", 0, 2),
            ("attn_batched", "hybrid_kernel", 0, 4), ("q_ilp", "mlp_bb2_kernel", 0, 2),
            ("q_ilp2", "attn_bb2_kernel", 0, 2), ("q_ilp2", "mlp_bb4_kernel", 0, 4),
            ("q_ilp3", "kern", 0, 2), ("q_ilp3", "kern", 1, 4), ("q_ilp4", "kern", 0, 2),
            ("q_ilp4", "kern", 1, 4)}
    assert want <= got
    assert [k.keywords for k in captured["bf16_chains"]["attn_chains_kernel"]] == [{"bb": 2}]


def _attn_ops(attn, jdt=None):
    ls, lb, wq, ws, bq, wo, wos, bo = attn
    return tuple(map(_jnp, (ls[None], lb[None], wq, ws.reshape(1, -1), bq[None], wo,
                            wos.reshape(1, -1), bo[None])))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("script,name,idx,twin", SITES,
                         ids=[f"{s}-{n}-{i}" for s, n, i, _ in SITES])
def test_body_matches_its_counterpart(captured, blocks, script, name, idx, twin, dtype):
    import jax.numpy as jnp

    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    kern = captured[script][name][idx]
    bb = captured[script].bb[name][idx]
    (attn, mlp), bf16 = blocks
    # q_ilp4's two packings run the same 4 images, each over its own grid
    x = _x(4 if twin == "postdiv" else bb, S, D, seed=50 + 3 * idx + bb)
    xt = _t(x, tdt)
    if twin == "k1":  # the script casts the weights to x's dtype; the twin rounds them so
        ls, lb, wqkv, bqkv, wo, bo = bf16
        ops = tuple(map(_jnp, (ls[None], lb[None], _jnp(wqkv, jdt), bqkv[None], _jnp(wo, jdt),
                               bo[None])))
        got = fb.attention_block(xt, *map(_t, bf16), heads=H)
    elif twin == "k4":
        ops = _pallas_ops(mlp)
        got = fbq.mlp_block_q(xt, *map(_t, mlp))
    else:
        ops = _attn_ops(attn)
        entry = fbq.attention_block_q if twin == "k3" else fbq.attention_block_q_postdiv
        got = entry(xt, *map(_t, attn), heads=H)
    ref = interpret(kern, _jnp(x, jdt), ops, bb=bb)
    if dtype == "float32" and twin in ("k3", "postdiv"):
        within_one_ulp(got, ref)
        if twin == "k3":
            from debias_vision_lang_tpu.ops import fused_block_q as jfbq

            same = jfbq.attention_block_q(_jnp(x), *map(_jnp, attn), heads=H, bb=1,
                                          interpret=True)
        else:  # the other packing
            same = interpret(captured["q_ilp4"]["kern"][1 - idx], _jnp(x), ops,
                             bb=captured["q_ilp4"].bb["kern"][1 - idx])
        np.testing.assert_array_equal(np.asarray(ref), np.asarray(same))
    else:
        check(got, ref, dtype, full_width=True)


def test_postdiv_is_not_k3(blocks):
    """q_ilp4's order moves the attention rows off K3's at bf16 (the
    unnormalised exponentials rounded, then divided), by about one bf16
    ulp of the rows' largest magnitude; at float32 only f32 rounding
    separates them."""
    attn = [_t(a) for a in blocks[0][0]]
    x = _t(_x(2, S, D, seed=60), torch.bfloat16)
    sk3, skp = {}, {}
    fbq.attention_block_q(x, *attn, heads=H, scratch=sk3)
    fbq.attention_block_q_postdiv(x, *attn, heads=H, scratch=skp)
    diff = (sk3["attn"] - skp["attn"]).abs()
    assert diff.ne(0).float().mean() > 0.05
    assert diff.max() <= _ulp(sk3["attn"].numpy())
    x32 = x.float()
    sk3, skp = {}, {}
    fbq.attention_block_q(x32, *attn, heads=H, scratch=sk3)
    fbq.attention_block_q_postdiv(x32, *attn, heads=H, scratch=skp)
    torch.testing.assert_close(sk3["attn"], skp["attn"], atol=1e-5, rtol=1e-5)


def test_postdiv_twin_does_not_count():
    attn = [_t(a) for a in _layer(64)[0]]
    fbq.reset_launches()
    fbq.attention_block_q_postdiv(_t(_x(2, 9, 64), torch.bfloat16), *attn, heads=1)
    assert fbq.KB_LAUNCHES["attention_block_q_postdiv"] == 0


def test_the_library_exports_the_postdiv_entry():
    import pathlib

    cu = (pathlib.Path(fbq.__file__).resolve().parent.parent / "csrc" / "fused_block_q.cu"
          ).read_text()
    assert "int dvl_attention_block_q_postdiv(" in cu
    assert "AQ_POSTDIV" in cu[cu.index("int attention_block_q_impl("):]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(4, S), (3, 77), (2, 400)])
def test_cuda_postdiv_matches_twin(b, s):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled with nvcc "
                    "for sm_90a and have no CPU mode")
    dev = torch.device("cuda")
    attn = [_t(a).to(dev) for a in _layer(D, seed=42)[0]]
    kw = {"wqkv_qt": attn[2].t().contiguous(), "wo_qt": attn[5].t().contiguous()}
    x = torch.from_numpy(_x(b, s, D, seed=s)).to(dev, torch.bfloat16)
    fbq.reset_launches()
    sk = {}
    got = fbq.attention_block_q_postdiv(x, *attn, heads=H, **kw, scratch=sk)
    torch.cuda.synchronize()
    assert fbq.KB_LAUNCHES["attention_block_q_postdiv"] == 1
    s3 = {}  # one LayerNorm-and-quantize pass: K3's LayerNorm rows of the same x
    fbq.attention_block_q(x, *attn, heads=H, **kw, scratch=s3)
    sk["xn"] = s3["xn"]
    for codes, rows, scales in (("xq", "xn", "xs"), ("aq", "attn", "as")):
        q, sc = fbq.quant_rows(sk[rows])
        assert torch.equal(q, sk[codes]) and torch.equal(sc, sk[scales])
    within_one_ulp(got.cpu(), fbq.attention_block_q_postdiv_plain(x, *attn, heads=H).cpu())
