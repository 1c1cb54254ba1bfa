#!/usr/bin/env python3
"""Where the time of the one-call int8 layer goes, on one CUDA card, and
its outputs against another checkout's: ``fused_block_q.fused_layer_q``
(benchmarks/q_layer_fused.py's ``layer_kernel``: K3 then K4 with y = x +
proj kept f32 between the halves), so that two checkouts of the port can be
compared in one run.

Digests (sha256 of the bytes) of the layer's output, y (f32), yb (its bf16
rounding; a checkout whose scratch has no yb gives bf16 of its y) and every
code and scale set it writes (xq xs aq as yq ys hq hs, and the rows attn
and h they quantize), in each case of ``CASES`` (ViT-B/16's widths at B=8
and the main path's B=256, the D=200 H=2 F=800 shape of smoke phase 27 at
B=8 S=77; x ~ N(0, 1) and x / 16), the output of a 12-layer tower of the
layer (``tower``: a random ViT-B/16 from seed 0, its image resblocks
quantized, on chip_smoke.py's KB input at B=256), and the SASS of every
kernel of the int8 library (``tp_slot_split.sass_digests``).

This checkout's layer also runs every product on the s8 GEMM
(``_fused_layer_q_cuda(..., tma=False)``) in every case, and each of that
route's outputs is held to the persistent GEMMs' route bit for bit.

With ``--split``: at B=256, for the layer (and, this checkout only, on the
s8 GEMM route): the device time of every kernel one call launches
(``torch.profiler`` over 10 calls, per launch), each beside its bound (the
larger of its operations over the card's peak for their type and its bytes
over 3.35 TB/s: ``role_bounds``); the host time of one call (median of 30);
the CUDA-event wall of 20 back-to-back calls (median of 5 runs); and the
12-layer tower's wall (3 calls, median of 5).  ``--routes`` (this checkout
only): the layer at B=256 on both routes, ten pairs in turns (the order
swapped every other pair): each route's median 20-call wall, and the pairs
the TMA route won.

    python3 benchmarks_torch/layer_split.py [--root CHECKOUT] [--label TAG]
        [--split] [--routes] [--dump FILE] [--against FILE]

``--root`` imports ``debias_vision_lang_torch`` from another checkout (a
parent commit unpacked with ``git archive``); its kernels build under that
checkout.  ``--dump`` writes the digests to FILE (JSON); ``--against``
compares them with such a file (``benchmarks_torch/layer_parent.json``: the
design before the layer's redesign, recorded with ``--root`` on it): the
outputs bit for bit, and which kernels of the library were added, removed
or compiled otherwise.  Prints the card's nvidia-smi name and power limit.
Exits 2 without a card, 1 if an output or a kernel differs under
``--against``.
"""

import argparse
import importlib.util
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (label, B, S, D, heads, F, x scale, weight seed)
CASES = (("ViT-B/16 B=8", 8, 197, 768, 12, 3072, 1.0, 41),
         ("ViT-B/16 B=8 x/16", 8, 197, 768, 12, 3072, 1 / 16, 41),
         ("ViT-B/16 B=256", 256, 197, 768, 12, 3072, 1.0, 41),
         ("ViT-B/16 B=256 x/16", 256, 197, 768, 12, 3072, 1 / 16, 41),
         ("D=200 H=2 F=800 B=8", 8, 77, 200, 2, 800, 1.0, 42),
         ("D=200 H=2 F=800 B=8 x/16", 8, 77, 200, 2, 800, 1 / 16, 42))
SPLIT_CASE = CASES[2]  # the main path's B=256
# the scratch sets digested, and the output; yb falls back to bf16(y)
KEYS = ("out", "y", "yb", "xq", "xs", "attn", "aq", "as", "yq", "ys", "h", "hq", "hs")
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
    """One case's seeded layer parameters, the ``fused_layer_q`` argument
    order ((17 tensors), {the *_qt copies}), and x."""
    import torch
    from debias_vision_lang_torch.ops.quant import QWeight

    _, b, s, d, heads, f, scale, seed = case
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
    args = (*ln1, wqkv.q, wqkv.scale, bqkv, wo.q, wo.scale, bo, *ln2, w1.q, w1.scale, b1,
            w2.q, w2.scale, b2)
    kw = {"wqkv_qt": wqkv.qt, "wo_qt": wo.qt, "w1_qt": w1.qt, "w2_qt": w2.qt}
    return args, kw, x


def layer_outputs(fbq, case, dev, tma=True):
    """{key: tensor} of one layer call on the case's inputs (``tma=False``:
    this checkout's s8 GEMM route)."""
    args, kw, x = case_block(case, dev)
    sk = {}
    if tma:
        out = fbq.fused_layer_q(x, *args, heads=case[4], **kw, scratch=sk)
    else:
        attn, mlp = layer_ops(args, kw)
        out = fbq._fused_layer_q_cuda(x, attn, mlp, case[4], sk, tma=False)
    sk["out"] = out
    if "yb" not in sk:
        sk["yb"] = sk["y"].to(out.dtype)
    return sk


def tower(fbq, dev):
    """The 12-layer tower: a random ViT-B/16 DebiasCLIP from seed 0, its
    image resblocks quantized (``quantize_resblocks``), the layer on each in
    turn from chip_smoke.py's KB input at B=256 (numpy seed 23, N(0, 1/4),
    bf16).  Returns (x -> out, x)."""
    import numpy as np
    import torch
    from debias_vision_lang_torch.models.debias import DebiasCLIP
    from debias_vision_lang_torch.ops.quant import quantize_resblocks

    model, _, _, _ = DebiasCLIP.from_cfg(
        {"CLIP_ARCH": "openai/CLIP/ViT-B/16", "PRETRAINED": False, "NUM_DEBIAS_TOKENS": 2,
         "DEBIAS_POS": "prepend", "SEED": 0}, device=dev)
    blocks = quantize_resblocks(model.clip.visual.resblocks)
    heads = model.clip_cfg.vision.heads
    rng = np.random.default_rng(23)
    x0 = torch.from_numpy((rng.normal(size=(256, 197, 768)) * 0.5).astype(np.float32)).to(
        dev, torch.bfloat16)

    def run(x):
        for blk in blocks:
            x = fbq.fused_layer_q(
                x, blk.ln_1.scale, blk.ln_1.bias, blk.wqkv.q, blk.wqkv.scale, blk.bqkv,
                blk.wo.q, blk.wo.scale, blk.bo, blk.ln_2.scale, blk.ln_2.bias, blk.w1.q,
                blk.w1.scale, blk.b1, blk.w2.q, blk.w2.scale, blk.b2, heads=heads,
                wqkv_qt=blk.wqkv.qt, wo_qt=blk.wo.qt, w1_qt=blk.w1.qt, w2_qt=blk.w2.qt)
        return x

    return run, x0


def output_digests(fbq, dev, each=None, towers=True):
    """{case: {key: digest}} of every case and (``towers``) of the tower's
    output; ``each(case, outputs)`` sees each case's tensors."""
    import torch

    out = {}
    with torch.no_grad():
        for case in CASES:
            sk = layer_outputs(fbq, case, dev)
            out[case[0]] = {k: S.digest(sk[k]) for k in KEYS}
            if each is not None:
                each(case, sk)
            del sk
        if towers:
            run, x0 = tower(fbq, dev)
            out[f"tower {TOWER_LAYERS} layers B=256"] = {"out": S.digest(run(x0))}
    torch.cuda.empty_cache()
    return out


def flat(digests):
    """{"case key": digest}: ``tp_slot_split.compare``'s form."""
    return {f"{c} {k}": [v] for c, kv in digests.items() for k, v in kv.items()}


def role_of(name):
    """The layer's sub-kernel a profiler kernel name stands for."""
    if name.startswith("ln_quant_rows_kernel"):
        return "LN + quantize"
    if name.startswith("layer_norm_kernel"):
        return "LN"
    if name.startswith("quant_rows_kernel"):
        return "quantize bf16 rows" if "bfloat16" in name else "quantize h"
    if name.startswith("attention_"):
        return "core"
    if name.startswith("gemm_s8_tma_kernel"):  # the persistent GEMMs: QKV, down
        return "QKV GEMM"
    if name.startswith("gemm_s8_epi_kernel"):
        return "down GEMM"
    if name.startswith("gemm_s8_kernel<"):
        epi = name[len("gemm_s8_kernel<"):].split(",")[0].rstrip(">")
        return {"0": "QKV GEMM", "8": "out GEMM", "2": "up GEMM", "9": "down GEMM"}.get(epi, name)
    return name


def role_bounds(b, s, d, heads, f):
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
        "QKV GEMM": bd(2 * m * d * 3 * d, "int8", m * d + 3 * d * d + 12 * d * 2 + m * 3 * d * 2),
        "core": bd(4 * b * s * s * d, "bf16", m * 3 * d * 2 + m * d * 2),
        "out GEMM": bd(2 * m * d * d, "int8", m * d + d * d + 8 * d + m * d * 2 + m * d * 6),
        "up GEMM": bd(2 * m * d * f, "int8", m * d + d * f + 8 * f + m * f * 4),
        "down GEMM": bd(2 * m * f * d, "int8", m * f + d * f + 8 * d + m * d * 4 + m * d * 2),
    }


def layer_bound(b, s, d, f):
    """The whole layer's least time (chip_smoke.py::layer_work's count: the
    four int8 products and the bf16 core against x read and out written
    once, the weights, scales and biases read once)."""
    m = b * s
    t_ops = (2 * m * d * 3 * d + 2 * m * d * d + 4 * m * d * f) / PEAK["int8"] + \
        4 * b * s * s * d / PEAK["bf16"]
    nbytes = 2 * m * d * 2 + 4 * d * d + 6 * d * 4 + (3 * d + d) * 4 + 2 * d * f + \
        (3 * d + f) * 4 + (f + d) * 4
    return max(t_ops, nbytes / HBM_BYTES_PER_S) * 1e3


def time_layer(what, fn, case, name, tag):
    """The split of one layer call: device ms per kernel (per launch, and
    launches a call), each sub-kernel's bound and share, host ms a call,
    20-call wall.  Returns the record."""
    _, b, s, d, heads, f, *_ = case
    bounds = role_bounds(b, s, d, heads, f)
    prof = S.profiled(fn, 10, tries=3)
    parts, dev_ms = [], 0.0
    for kname, ms, n in prof:
        role = role_of(kname)
        per, count = ms / n, max(1, round(n / 10))
        dev_ms += per * count
        bms, by = bounds.get(role, (float("nan"), "-"))
        parts.append(f"{role} [{kname}] {per:.4f} ms x {count} (bound {bms:.4f}, {by}; "
                     f"{bms / per:.0%})")
    host = S.host_ms(fn)
    wall = statistics.median(S.events_ms(fn, 20) for _ in range(5))
    whole = layer_bound(b, s, d, f)
    device = f"{dev_ms:.4f} ms" if prof else "not measured (the profiler recorded no kernel)"
    print(f"{tag}{what}: device {device} a call ({'; '.join(parts)}); host {host:.4f} ms a "
          f"call; 20-call wall {wall:.4f} ms (median of 5); the layer's bound {whole:.4f} ms "
          f"({whole / wall:.1%} of the wall) ({name})", flush=True)
    return {"device": dev_ms, "host": host, "wall20": wall}


def split(fbq, dev, name, tag, own):
    """``--split``: the layer at B=256 on its route and (``own``: this
    checkout) on the other, and the 12-layer tower's wall."""
    import torch

    case = SPLIT_CASE
    args, kw, x = case_block(case, dev)
    heads = case[4]
    with torch.no_grad():
        time_layer(f"fused_layer_q {case[0]} S={case[2]} D={case[3]}",
                   lambda: fbq.fused_layer_q(x, *args, heads=heads, **kw), case, name, tag)
        if own:
            attn, mlp = layer_ops(args, kw)
            time_layer(f"fused_layer_q {case[0]} with every product on the s8 GEMM",
                       lambda: fbq._fused_layer_q_cuda(x, attn, mlp, heads, None, tma=False),
                       case, name, tag)
        run, x0 = tower(fbq, dev)
        ms = statistics.median(S.events_ms(lambda: run(x0), 3) for _ in range(5))
        print(f"{tag}tower of {TOWER_LAYERS} layers B=256: {ms:.3f} ms a call (3-call wall, "
              f"median of 5) ({name})", flush=True)


def layer_ops(args, kw):
    """``_fused_layer_q_cuda``'s two halves' parameters from fused_layer_q's
    arguments."""
    (l1s, l1b, _, wqs, bq, _, wos, bo, l2s, l2b, _, w1s, b1, _, w2s, b2) = args
    return ((l1s, l1b, wqs, bq, wos, bo, kw["wqkv_qt"], kw["wo_qt"]),
            (l2s, l2b, w1s, b1, w2s, b2, kw["w1_qt"], kw["w2_qt"]))


def routes(fbq, dev, name, tag, pairs=10):
    """``--routes``: the layer at B=256 on its route (``layer_route``: the
    QKV and down products on the persistent GEMMs) and on the s8 GEMM
    route, ``pairs`` pairs in turns (the order swapped every other pair);
    per route the median 20-call wall, and the pairs its route won."""
    import torch

    case = SPLIT_CASE
    args, kw, x = case_block(case, dev)
    attn, mlp = layer_ops(args, kw)
    got = {True: [], False: []}
    for p in range(pairs):
        for tma in ((True, False) if p % 2 == 0 else (False, True)):
            got[tma].append(S.events_ms(lambda: fbq._fused_layer_q_cuda(
                x, attn, mlp, case[4], None, tma=tma), 20))
    won = sum(a < b for a, b in zip(got[True], got[False]))
    print(f"{tag}routes fused_layer_q {case[0]}: 20-call wall {statistics.median(got[True]):.4f} "
          f"ms on its route ({fbq.layer_route(case[3])}), {statistics.median(got[False]):.4f} on "
          f"the s8 GEMM; its route won {won} of {pairs} pairs ({name})", flush=True)
    del x
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE, help="the checkout whose port is run")
    ap.add_argument("--label", default="", help="a tag printed on every line")
    ap.add_argument("--split", action="store_true", help="time the layer at B=256")
    ap.add_argument("--routes", action="store_true", help="time both routes in turns")
    ap.add_argument("--dump", help="write the outputs' and kernels' digests to this file")
    ap.add_argument("--against", help="compare with the digests in this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("layer_split: no CUDA device found", file=sys.stderr)
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
            entry = (line.split("'")[1] if "gemm_s8_tma_kernel" in line
                     or "gemm_s8_epi_kernel" in line else None)
        elif entry and ("Used" in line or "spill" in line):
            print(f"{tag}ptxas {entry}: {line.strip()}", flush=True)

    mismatched = []

    def each(case, sk):  # this checkout: yb is bf16(y), the s8 GEMM route the same
        yb = torch.equal(sk["yb"], sk["y"].to(torch.bfloat16))
        other = layer_outputs(fbq, case, dev, tma=False)
        off = [k for k in KEYS if not torch.equal(sk[k], other[k])]
        mismatched.extend(f"{case[0]} {k}" for k in off + ([] if yb else ["yb"]))
        print(f"{tag}{case[0]}: yb {'is' if yb else 'is NOT'} bf16(y) bit for bit; the s8 GEMM "
              f"route's outputs {'all bit-identical' if not off else f'DIFFER: {off}'}",
              flush=True)

    digests = {"outputs": output_digests(fbq, dev, each if own else None), "sass": sass}
    if own:
        print(f"{tag}layer routes: {fbq.LAYER_ROUTES}", flush=True)
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
