#!/usr/bin/env python3
"""Where the time of KB (a) 3 and of q_ilp4's attention goes, on one CUDA
card, and their outputs against another checkout's:
``fused_block_q.mlp_block_q_var`` (benchmarks/q_kernel_variants.py's
``make_mlp_var(bf16_gelu)``: K4 with the reciprocal quantizer on x and on
the hidden, quick_gelu in f32 or in XLA's bf16 form) and
``attention_block_q_postdiv`` (benchmarks/q_ilp4.py's ``make_call``: K3 with
the softmax's row sum divided out after P V), so that two checkouts of the
port can be compared in one run.

Digests (sha256 of the bytes) of each entry's output and of every row set
its scratch holds (the MLP: xq xs h hq hs; the attention: xq xs attn aq
as), in each case of ``CASES``: ViT-B/16's widths at B=8 and the main
path's B=256 with x ~ N(0, 1) and x / 16, the int8 joint Frozen-in-Time
shape B=32 S=785, SigLIP-So400m's widths (D = 1,152, 16 heads of 72, F =
4,304) and D=200 (2 heads, F = 800), for each of the three entries (``var``:
f32 quick_gelu, ``var_bf16``: the bf16 one, ``postdiv``).  Then the output of
each entry's 12-layer tower (``tower``: a random ViT-B/16 from seed 0, its
image resblocks quantized, the entry's halves chained on chip_smoke.py's
KB input at B=256), and the SASS of every kernel of the int8 library
(``tp_slot_split.sass_digests``).

This checkout's entries also run on their other route in every case
(``_mlp_block_q_cuda(..., tma=False)`` / ``_attention_block_q_cuda(...,
tma=False)``: the launches the entries ran before their redesign), and
its outputs are held to the default route's bit for bit.

With ``--split``: at B=256, the three entries and K3 / K4 beside them: the
device time of every kernel one call launches (``torch.profiler`` over 10
calls, per launch), each beside its bound (``role_bounds``: the larger of
its operations over the card's peak for their type and its bytes over 3.35
TB/s); the host time of one call (median of 30); the CUDA-event wall of 20
back-to-back calls (median of 5 runs); and the 12-layer towers' walls (3
calls, median of 5).  ``--routes`` (this checkout only): each entry at
B=256 on its route and on the other, ten pairs in turns (the order swapped
every other pair): each route's median 20-call wall, and the pairs the
default route won.

    python3 benchmarks_torch/kb_var_split.py [--root CHECKOUT] [--label TAG]
        [--split] [--routes] [--no-digests] [--dump FILE] [--against FILE]

``--root`` imports ``debias_vision_lang_torch`` from another checkout (a
parent commit unpacked with ``git archive``); its kernels build under that
checkout.  ``--dump`` writes the digests to FILE (JSON); ``--against``
compares them with such a file (``benchmarks_torch/kb_var_parent.json``: the
design before the two entries' redesign, recorded with ``--root`` on it):
the outputs bit for bit, and which kernels of the library were added,
removed or compiled otherwise.  Prints the card's nvidia-smi name and power
limit.  Exits 2 without a card, 1 if an output or a kernel differs under
``--against``.
"""

import argparse
import importlib.util
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIT = (197, 768, 12, 3072)  # S, D, heads, F
ENTRIES = ("var", "var_bf16", "postdiv")
# (label, B, S, D, heads, F, x scale, weight seed)
SHAPES = tuple(
    [(f"ViT-B/16 B={b}{' x/16' if sc != 1 else ''}", b, *VIT, sc, 41)
     for b in (8, 256) for sc in (1.0, 1 / 16)]
    + [("FiT B=32 S=785", 32, 785, 768, 12, 3072, 0.5, 41),
       ("SigLIP-So400m B=8 S=257", 8, 257, 1152, 16, 4304, 1.0, 43),
       ("D=200 H=2 F=800 B=8 S=77", 8, 77, 200, 2, 800, 1.0, 42),
       ("D=200 H=2 F=800 B=8 S=77 x/16", 8, 77, 200, 2, 800, 1 / 16, 42)])
# (label, entry, B, S, D, heads, F, x scale, weight seed)
CASES = tuple((f"{kind} {shape[0]}", kind, *shape[1:]) for kind in ENTRIES for shape in SHAPES)
KEYS = {"var": ("out", "xq", "xs", "h", "hq", "hs"),
        "var_bf16": ("out", "xq", "xs", "h", "hq", "hs"),
        "postdiv": ("out", "xq", "xs", "attn", "aq", "as")}
SPLIT_B = 256
TOWER_LAYERS = 12
HBM_BYTES_PER_S = 3.35e12
PEAK = {"int8": 1979e12, "bf16": 989e12}


def _split_module():
    """benchmarks_torch/tp_slot_split.py (digests, SASS, timers)."""
    spec = importlib.util.spec_from_file_location(
        "tp_slot_split", os.path.join(HERE, "benchmarks_torch", "tp_slot_split.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


S = _split_module()


def case_block(case, dev):
    """One case's seeded parameters: (the attention half's 9 tensors, the
    MLP half's 8, {the *_qt copies}) and x."""
    import torch
    from debias_vision_lang_torch.ops.quant import QWeight

    _, _, b, s, d, _, f, scale, seed = case
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * std

    ln1 = (1 + 0.1 * rn(d), 0.1 * rn(d))
    wqkv, bqkv = QWeight(rn(d, 3 * d, std=d ** -0.5)), 0.1 * rn(3 * d)
    wo, bo = QWeight(rn(d, d, std=d ** -0.5)), 0.1 * rn(d)
    ln2 = (1 + 0.1 * rn(d), 0.1 * rn(d))
    w1, b1 = QWeight(rn(d, f, std=(2 * d) ** -0.5)), 0.1 * rn(f)
    w2, b2 = QWeight(rn(f, d, std=f ** -0.5)), 0.1 * rn(d)
    x = (rn(b, s, d) * scale).to(torch.bfloat16)
    attn = (*ln1, wqkv.q, wqkv.scale, bqkv, wo.q, wo.scale, bo)
    mlp = (*ln2, w1.q, w1.scale, b1, w2.q, w2.scale, b2)
    kw = {"wqkv_qt": wqkv.qt, "wo_qt": wo.qt, "w1_qt": w1.qt, "w2_qt": w2.qt}
    return attn, mlp, kw, x


def call(fbq, kind, heads, x, attn, mlp, kw, scratch=None, tma=True):
    """One call of the entry (``tma=False``: this checkout's other route,
    the launches of the design before the redesign)."""
    if kind == "postdiv":
        if tma:
            return fbq.attention_block_q_postdiv(x, *attn, heads=heads, wqkv_qt=kw["wqkv_qt"],
                                                 wo_qt=kw["wo_qt"], scratch=scratch)
        (ls, lb, _, wqs, bq, _, wos, bo) = attn
        return fbq._attention_block_q_cuda(x, ls, lb, wqs, bq, wos, bo, heads, False,
                                           kw["wqkv_qt"], kw["wo_qt"], scratch, kind="postdiv",
                                           tma=False)
    if tma:
        return fbq.mlp_block_q_var(x, *mlp, bf16_gelu=kind == "var_bf16", w1_qt=kw["w1_qt"],
                                   w2_qt=kw["w2_qt"], scratch=scratch)
    (ls, lb, _, w1s, b1, _, w2s, b2) = mlp
    return fbq._mlp_block_q_cuda(x, ls, lb, w1s, b1, w2s, b2, "quick_gelu", kw["w1_qt"],
                                 kw["w2_qt"], scratch,
                                 kind="var_bf16_gelu" if kind == "var_bf16" else "var",
                                 tma=False)


def case_outputs(fbq, case, dev, tma=True):
    """{key: tensor} of one call on the case's inputs."""
    attn, mlp, kw, x = case_block(case, dev)
    sk = {}
    sk["out"] = call(fbq, case[1], case[5], x, attn, mlp, kw, sk, tma)
    return sk


_TOWER = None


def tower(fbq, dev, kind):
    """A 12-layer tower of the entry's halves: a random ViT-B/16
    DebiasCLIP from seed 0, its image resblocks quantized
    (``quantize_resblocks``), the entry on each in turn (``kind`` in
    ENTRIES, or "k3" / "k4") from chip_smoke.py's KB input at B=256 (numpy
    seed 23, N(0, 1/4), bf16).  Returns (x -> out, x)."""
    import numpy as np
    import torch
    from debias_vision_lang_torch.models.debias import DebiasCLIP
    from debias_vision_lang_torch.ops.quant import quantize_resblocks

    global _TOWER
    if _TOWER is None:
        model, _, _, _ = DebiasCLIP.from_cfg(
            {"CLIP_ARCH": "openai/CLIP/ViT-B/16", "PRETRAINED": False, "NUM_DEBIAS_TOKENS": 2,
             "DEBIAS_POS": "prepend", "SEED": 0}, device=dev)
        rng = np.random.default_rng(23)
        x0 = torch.from_numpy((rng.normal(size=(256, 197, 768)) * 0.5).astype(np.float32)).to(
            dev, torch.bfloat16)
        _TOWER = (quantize_resblocks(model.clip.visual.resblocks),
                  model.clip_cfg.vision.heads, x0)
        del model
    blocks, heads, x0 = _TOWER

    def run(x):
        for blk in blocks:
            if kind in ("postdiv", "k3"):
                args = (blk.ln_1.scale, blk.ln_1.bias, blk.wqkv.q, blk.wqkv.scale, blk.bqkv,
                        blk.wo.q, blk.wo.scale, blk.bo)
                entry = fbq.attention_block_q_postdiv if kind == "postdiv" \
                    else fbq.attention_block_q
                x = entry(x, *args, heads=heads, wqkv_qt=blk.wqkv.qt, wo_qt=blk.wo.qt)
                continue
            args = (blk.ln_2.scale, blk.ln_2.bias, blk.w1.q, blk.w1.scale, blk.b1, blk.w2.q,
                    blk.w2.scale, blk.b2)
            kw = {"w1_qt": blk.w1.qt, "w2_qt": blk.w2.qt}
            if kind == "k4":
                x = fbq.mlp_block_q(x, *args, **kw)
            else:
                x = fbq.mlp_block_q_var(x, *args, bf16_gelu=kind == "var_bf16", **kw)
        return x

    return run, x0


def output_digests(fbq, dev, each=None, cases=CASES, towers=ENTRIES):
    """{case: {key: digest}} of ``cases`` and of the ``towers``' outputs;
    ``each(case, outputs)`` sees each case's tensors."""
    import torch

    out = {}
    with torch.no_grad():
        for case in cases:
            sk = case_outputs(fbq, case, dev)
            out[case[0]] = {k: S.digest(sk[k]) for k in KEYS[case[1]]}
            if each is not None:
                each(case, sk)
            del sk
        for kind in towers:
            run, x0 = tower(fbq, dev, kind)
            out[f"tower {TOWER_LAYERS} layers {kind} B=256"] = {"out": S.digest(run(x0))}
    torch.cuda.empty_cache()
    return out


def other_routes(fbq, case, dev):
    """[(route, {key: tensor})] of this checkout's other routes on the case:
    the launches before the redesign ("gemm")."""
    return [("gemm", case_outputs(fbq, case, dev, tma=False))]


def flat(digests):
    """{"case key": digest}: ``tp_slot_split.compare``'s form."""
    return {f"{c} {k}": [v] for c, kv in digests.items() for k, v in kv.items()}


def role_of(name):
    """The entry's sub-kernel a profiler kernel name stands for."""
    if name.startswith("ln_quant"):
        return "LN + quantize"
    if name.startswith("layer_norm_kernel"):
        return "LN"
    if name.startswith("quant_rows_kernel") or name.startswith("quant_rows_wide_kernel"):
        return "quantize bf16 rows" if "bfloat16" in name else "quantize h"
    if name.startswith("attention_"):
        return "core"
    if name.startswith("gemm_s8_tma_kernel"):
        return "QKV GEMM"
    if name.startswith("gemm_s8_kernel<"):
        epi = name[len("gemm_s8_kernel<"):].split(",")[0].rstrip(">")
        return {"0": "QKV GEMM", "1": "out GEMM", "2": "up GEMM", "7": "up GEMM",
                "4": "down GEMM"}.get(epi, name)
    return name


def role_bounds(b, s, d, f):
    """{sub-kernel: (ms, by)} at B, S, D, F: each launch's least time, the
    larger of its operations over the peak for their type (int8 products at
    1,979 TOP/s, the bf16 core at 989 TFLOP/s) and its bytes (each input read
    once, each output written once) over 3.35 TB/s.  Sizes at the model's
    widths (DK = D rounded up to 64 for the codes, as the kernels write)."""
    m, dk = b * s, -(-d // 64) * 64

    def bd(ops, kind, nbytes):
        t_ops, t_bytes = ops / PEAK[kind], nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")

    return {
        "LN + quantize": bd(0, "int8", m * d * 2 + m * dk + 4 * m + 8 * d),
        "LN": bd(0, "int8", m * d * 2 + m * dk * 2 + 8 * d),
        "quantize bf16 rows": bd(0, "int8", m * d * 2 + m * d + 4 * m),
        "quantize h": bd(0, "int8", m * f * 4 + m * f + 4 * m),
        "QKV GEMM": bd(2 * m * d * 3 * d, "int8", m * dk + 4 * m + 3 * d * d + 24 * d
                       + m * 3 * d * 2),
        "core": bd(4 * b * s * s * d, "bf16", m * 3 * d * 2 + m * d * 2),
        "out GEMM": bd(2 * m * d * d, "int8", m * d + 4 * m + d * d + 8 * d + m * d * 2 * 2),
        "up GEMM": bd(2 * m * d * f, "int8", m * dk + 4 * m + d * f + 8 * f + m * f * 4),
        "down GEMM": bd(2 * m * f * d, "int8", m * f + 4 * m + d * f + 8 * d + m * d * 2 * 2),
    }


def entry_bound(kind, b, s, d, f):
    """The whole entry's least time (chip_smoke.py's count: the int8
    products (and the bf16 core) against x read and out written once, the
    weights, scales, biases and LayerNorm parameters read once)."""
    m = b * s
    if kind in ("postdiv", "k3"):
        t_ops = (2 * m * d * 3 * d + 2 * m * d * d) / PEAK["int8"] + \
            4 * b * s * s * d / PEAK["bf16"]
        nbytes = 2 * m * d * 2 + 4 * d * d + (3 * d + d) * 8 + 2 * d * 4
    else:
        t_ops = 4 * m * d * f / PEAK["int8"]
        nbytes = 2 * m * d * 2 + 2 * d * f + 2 * (f + d) * 4 + 2 * d * 4
    return max(t_ops, nbytes / HBM_BYTES_PER_S) * 1e3


def time_entry(what, fn, kind, dims, name, tag):
    """The split of one call: device ms per kernel (per launch, and launches
    a call), each sub-kernel's bound and share, host ms a call, 20-call
    wall.  Returns the record."""
    b, s, d, f = dims
    bounds = role_bounds(b, s, d, f)
    prof = S.profiled(fn, 10, tries=3)
    parts, dev_ms, launches = [], 0.0, 0
    for kname, ms, n in prof:
        role = role_of(kname)
        per, count = ms / n, max(1, round(n / 10))
        dev_ms += per * count
        launches += count
        bms, by = bounds.get(role, (float("nan"), "-"))
        parts.append(f"{role} [{kname}] {per:.4f} ms x {count} (bound {bms:.4f}, {by}; "
                     f"{bms / per:.0%})")
    host = S.host_ms(fn)
    wall = statistics.median(S.events_ms(fn, 20) for _ in range(5))
    whole = entry_bound(kind, b, s, d, f)
    device = f"{dev_ms:.4f} ms" if prof else "not measured (the profiler recorded no kernel)"
    print(f"{tag}{what}: device {device} a call in {launches} launches ({'; '.join(parts)}); "
          f"host {host:.4f} ms a call; 20-call wall {wall:.4f} ms (median of 5); the entry's "
          f"bound {whole:.4f} ms ({whole / wall:.1%} of the wall) ({name})", flush=True)
    return {"device": dev_ms, "host": host, "wall20": wall, "launches": launches}


def split(fbq, dev, name, tag, own):
    """``--split``: K3, K4 and the three entries at B=256 on their routes and
    (``own``: this checkout) on the other, then the towers' walls."""
    import torch

    case = ("split", "var", SPLIT_B, *VIT, 0.5, 41)
    attn, mlp, kw, x = case_block(case, dev)
    s, d, heads, f = VIT
    dims = (SPLIT_B, s, d, f)
    with torch.no_grad():
        time_entry(f"K3 attention_block_q B={SPLIT_B}",
                   lambda: fbq.attention_block_q(x, *attn, heads=heads, wqkv_qt=kw["wqkv_qt"],
                                                 wo_qt=kw["wo_qt"]), "k3", dims, name, tag)
        time_entry(f"K4 mlp_block_q B={SPLIT_B}",
                   lambda: fbq.mlp_block_q(x, *mlp, w1_qt=kw["w1_qt"], w2_qt=kw["w2_qt"]),
                   "k4", dims, name, tag)
        for kind in ENTRIES:
            time_entry(f"{kind} B={SPLIT_B}",
                       lambda: call(fbq, kind, heads, x, attn, mlp, kw), kind, dims, name, tag)
            if own:
                time_entry(f"{kind} B={SPLIT_B} on its other route",
                           lambda: call(fbq, kind, heads, x, attn, mlp, kw, tma=False), kind,
                           dims, name, tag)
        for kind in ("k3", "k4", *ENTRIES):
            run, x0 = tower(fbq, dev, kind)
            ms = statistics.median(S.events_ms(lambda: run(x0), 3) for _ in range(5))
            bound = TOWER_LAYERS * entry_bound(kind, *dims)
            print(f"{tag}tower of {TOWER_LAYERS} {kind} halves B={SPLIT_B}: {ms:.3f} ms a call "
                  f"(3-call wall, median of 5; bound {bound:.4f} ms) ({name})", flush=True)
    del x
    torch.cuda.empty_cache()


def routes(fbq, dev, name, tag, pairs=10):
    """``--routes``: each entry at B=256 on its route and on the other,
    ``pairs`` pairs in turns (the order swapped every other pair); per route
    the median 20-call wall, and the pairs its default route won."""
    import torch

    case = ("routes", "var", SPLIT_B, *VIT, 0.5, 41)
    attn, mlp, kw, x = case_block(case, dev)
    heads = VIT[2]
    for kind in ENTRIES:
        got = {True: [], False: []}
        for p in range(pairs):
            for tma in ((True, False) if p % 2 == 0 else (False, True)):
                got[tma].append(S.events_ms(
                    lambda: call(fbq, kind, heads, x, attn, mlp, kw, tma=tma), 20))
        won = sum(a < b for a, b in zip(got[True], got[False]))
        route = "ln" if kind != "postdiv" else "tma"
        print(f"{tag}routes {kind} B={SPLIT_B}: 20-call wall {statistics.median(got[True]):.4f} "
              f"ms on its route ({route}), {statistics.median(got[False]):.4f} on the other; "
              f"its route won {won} of {pairs} pairs ({name})", flush=True)
    del x
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE, help="the checkout whose port is run")
    ap.add_argument("--label", default="", help="a tag printed on every line")
    ap.add_argument("--split", action="store_true", help="time the entries at B=256")
    ap.add_argument("--routes", action="store_true", help="time both routes in turns")
    ap.add_argument("--no-digests", action="store_true",
                    help="skip the cases' digests (a timing run of a design under test)")
    ap.add_argument("--dump", help="write the outputs' and kernels' digests to this file")
    ap.add_argument("--against", help="compare with the digests in this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kb_var_split: no CUDA device found", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from debias_vision_lang_torch.ops import _build
    from debias_vision_lang_torch.ops import fused_block_q as fbq

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    name = S.card()
    tag = f"{args.label} " if args.label else ""
    own = root == os.path.abspath(HERE)
    fbq.build()
    sass = S.sass_digests(_build.LIB_PATHS["fused_block_q"])
    print(f"{tag}fused_block_q library: {len(sass)} kernels in its SASS ({name})", flush=True)
    entry = None
    for line in _build.BUILD_LOG.get("fused_block_q", "").splitlines():  # -Xptxas -v
        if "Compiling entry function" in line:
            entry = (line.split("'")[1] if any(k in line for k in (
                "ln_quant_recip", "attention_wgmma_kernelILi200ELi0ELi2E",
                "gemm_s8_tma_kernel")) else None)
        elif entry and ("Used" in line or "spill" in line):
            print(f"{tag}ptxas {entry}: {line.strip()}", flush=True)

    mismatched = []

    def each(case, sk):  # this checkout: the other routes give the same outputs
        for what, other in other_routes(fbq, case, dev):
            off = [k for k in KEYS[case[1]] if not torch.equal(sk[k], other[k])]
            mismatched.extend(f"{case[0]} {what} {k}" for k in off)
            print(f"{tag}{case[0]}: the {what} route's outputs "
                  f"{'all bit-identical' if not off else f'DIFFER: {off}'}", flush=True)

    if own:
        fbq.reset_launches()
    digests = {"outputs": {} if args.no_digests else output_digests(fbq, dev,
                                                                      each if own else None),
               "sass": sass}
    if own:
        print(f"{tag}routes taken: var {fbq.VAR_ROUTES}, postdiv {fbq.POSTDIV_ROUTES}",
              flush=True)
    if args.split:
        split(fbq, dev, name, tag, own)
    if args.routes and own:
        routes(fbq, dev, name, tag)
    if args.dump:
        os.makedirs(os.path.dirname(os.path.abspath(args.dump)), exist_ok=True)
        with open(args.dump, "w") as fh:
            json.dump(digests, fh, indent=1, sort_keys=True)
    if not args.against:
        return 1 if mismatched else 0
    with open(args.against) as fh:
        theirs = json.load(fh)
    bad = S.compare({"outputs": flat(digests["outputs"]), "sass": sass},
                    {"outputs": flat(theirs["outputs"]), "sass": theirs["sass"]},
                    args.against, tag)
    return 1 if bad or mismatched else 0


if __name__ == "__main__":
    sys.exit(main())
