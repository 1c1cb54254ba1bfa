#!/usr/bin/env python3
"""Where the time of K4's F-split and of KB (a) 2's bf16-hidden MLP goes, on
one CUDA card, and their outputs against another checkout's:
``fused_block_q.mlp_block_q(fb=)`` (benchmarks/q_ilp.py's ``make_fsplit(k)``:
each fb-wide chunk of a hidden row quantized on its own, the chunks'
dequantized down products summed in f32) and ``mlp_block_q_bf16h``
(benchmarks/q_mlp_bf16h.py's ``pipe_kernel`` with bf16h: the up product's
deq + b1 rounded to bf16, quick_gelu applied in the hidden's quantize pass),
so that two checkouts of the port can be compared in one run.

Digests (sha256 of the bytes) of each entry's output and of every row set
its scratch holds (xq xs h hq hs; for bf16h also u, the bf16 pre-activation,
and h is then the f32 quick_gelu of it), in each case of ``CASES``:
ViT-B/16's widths at B=8 and the main path's B=256 with x ~ N(0, 1) and x /
16 at fb = 1,536, 768 and 1,024; the int8 joint Frozen-in-Time shape B=32
S=785 at fb = 1,024; fb = 192 (chunks padded to 256); SigLIP-So400m's
widths at fb = 1,076 (chunks padded to 1,152); D=200 F=800 at fb = 400
(chunks padded to 512); and KB (a) 2 at the same widths.  Then the output
of the two 12-layer towers (``tower``: a random ViT-B/16 from seed 0, its
image resblocks quantized, the MLP halves chained on chip_smoke.py's KB
input at B=256: the F-split at fb = 1,536 and bf16h), and the SASS of
every kernel of the int8 library (``tp_slot_split.sass_digests``).

This checkout's entries also run on their other route in every case
(``_mlp_block_q_cuda(..., tma=False)``: the F-split's down product on the
chunked s8 GEMM, KB (a) 2's up product on the s8 GEMM), and each of that
route's outputs is held to the default route's bit for bit.

With ``--split``: at B=256, for both entries (the F-split at fb = 1,536,
768 and 1,024) and K4 beside them: the device time of every kernel one
call launches (``torch.profiler`` over 10 calls, per launch), each beside
its bound (``role_bounds``: the larger of its operations over the card's
peak for their type and its bytes over 3.35 TB/s); the host time of one
call (median of 30); the CUDA-event wall of 20 back-to-back calls (median
of 5 runs); and the 12-layer towers' walls (3 calls, median of 5) beside
K4's.  ``--routes`` (this checkout only): each entry at B=256 on both
routes, ten pairs in turns (the order swapped every other pair): each
route's median 20-call wall, and the pairs the default route won.

    python3 benchmarks_torch/mlp_q_split.py [--root CHECKOUT] [--label TAG]
        [--split] [--routes] [--no-digests] [--dump FILE] [--against FILE]

``--root`` imports ``debias_vision_lang_torch`` from another checkout (a
parent commit unpacked with ``git archive``); its kernels build under that
checkout.  ``--dump`` writes the digests to FILE (JSON); ``--against``
compares them with such a file (``benchmarks_torch/mlp_q_parent.json``: the
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
VIT = (197, 768, 3072)  # S, D, F
# (label, kind, B, S, D, F, fb (None: bf16h), x scale, weight seed)
CASES = tuple(
    [(f"fsplit fb={fb} ViT-B/16 B={b}{' x/16' if sc != 1 else ''}", "fsplit", b, *VIT, fb, sc,
      41) for fb in (1536, 768, 1024) for b in (8, 256) for sc in (1.0, 1 / 16)]
    + [("fsplit fb=1024 FiT B=32 S=785", "fsplit", 32, 785, 768, 3072, 1024, 0.5, 41),
       ("fsplit fb=192 ViT-B/16 B=8", "fsplit", 8, *VIT, 192, 1.0, 41),
       ("fsplit fb=1076 SigLIP-So400m B=8 S=257", "fsplit", 8, 257, 1152, 4304, 1076, 1.0, 43),
       ("fsplit fb=400 D=200 F=800 B=8 S=77", "fsplit", 8, 77, 200, 800, 400, 1.0, 42),
       ("fsplit fb=400 D=200 F=800 B=8 S=77 x/16", "fsplit", 8, 77, 200, 800, 400, 1 / 16, 42)]
    + [(f"bf16h ViT-B/16 B={b}{' x/16' if sc != 1 else ''}", "bf16h", b, *VIT, None, sc, 41)
       for b in (8, 256) for sc in (1.0, 1 / 16)]
    + [("bf16h FiT B=32 S=785", "bf16h", 32, 785, 768, 3072, None, 0.5, 41),
       ("bf16h SigLIP-So400m B=8 S=257", "bf16h", 8, 257, 1152, 4304, None, 1.0, 43),
       ("bf16h D=200 F=800 B=8 S=77", "bf16h", 8, 77, 200, 800, None, 1.0, 42),
       ("bf16h D=200 F=800 B=8 S=77 x/16", "bf16h", 8, 77, 200, 800, None, 1 / 16, 42)])
KEYS = {"fsplit": ("out", "xq", "xs", "h", "hq", "hs"),
        "bf16h": ("out", "xq", "xs", "u", "h", "hq", "hs")}
# --split: the entries at B=256 (and K4 beside them)
SPLIT_FB = (1536, 768, 1024)
SPLIT_B = 256
TOWER_LAYERS = 12
TOWER_FB = 1536
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
    """One case's seeded MLP parameters in ``mlp_block_q``'s argument order
    ((8 tensors), {the *_qt copies}), and x."""
    import torch
    from debias_vision_lang_torch.ops.quant import QWeight

    _, _, b, s, d, f, _, scale, seed = case
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * std

    ln = (1 + 0.1 * rn(d), 0.1 * rn(d))
    w1, b1 = QWeight(rn(d, f, std=(2 * d) ** -0.5)), 0.1 * rn(f)
    w2, b2 = QWeight(rn(f, d, std=f ** -0.5)), 0.1 * rn(d)
    x = (rn(b, s, d) * scale).to(torch.bfloat16)
    return (*ln, w1.q, w1.scale, b1, w2.q, w2.scale, b2), {"w1_qt": w1.qt, "w2_qt": w2.qt}, x


def call(fbq, kind, fb, x, args, kw, scratch=None, tma=True):
    """One call of the entry (``tma=False``: this checkout's other route)."""
    if tma:
        if kind == "bf16h":
            return fbq.mlp_block_q_bf16h(x, *args, **kw, scratch=scratch)
        return fbq.mlp_block_q(x, *args, fb=fb, **kw, scratch=scratch)
    (ls, lb, _, w1s, b1, _, w2s, b2) = args
    return fbq._mlp_block_q_cuda(x, ls, lb, w1s, b1, w2s, b2, "quick_gelu", kw["w1_qt"],
                                 kw["w2_qt"], scratch, kind="bf16h" if kind == "bf16h" else "k4",
                                 fb=fb, tma=False)


def case_outputs(fbq, case, dev, tma=True):
    """{key: tensor} of one call on the case's inputs."""
    args, kw, x = case_block(case, dev)
    sk = {}
    sk["out"] = call(fbq, case[1], case[6], x, args, kw, sk, tma)
    return sk


def tower(fbq, dev, kind):
    """A 12-layer tower of MLP halves: a random ViT-B/16 DebiasCLIP from
    seed 0, its image resblocks quantized (``quantize_resblocks``), the
    entry on each in turn (the F-split at fb = TOWER_FB, or bf16h, or K4)
    from chip_smoke.py's KB input at B=256 (numpy seed 23, N(0, 1/4),
    bf16).  Returns (x -> out, x)."""
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
        _TOWER = (quantize_resblocks(model.clip.visual.resblocks), x0)
        del model
    blocks, x0 = _TOWER

    def run(x):
        for blk in blocks:
            args = (blk.ln_2.scale, blk.ln_2.bias, blk.w1.q, blk.w1.scale, blk.b1, blk.w2.q,
                    blk.w2.scale, blk.b2)
            kw = {"w1_qt": blk.w1.qt, "w2_qt": blk.w2.qt}
            if kind == "bf16h":
                x = fbq.mlp_block_q_bf16h(x, *args, **kw)
            else:
                x = fbq.mlp_block_q(x, *args, fb=TOWER_FB if kind == "fsplit" else None, **kw)
        return x

    return run, x0


_TOWER = None


def output_digests(fbq, dev, each=None, cases=CASES, towers=("fsplit", "bf16h")):
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
            label = f"fb={TOWER_FB}" if kind == "fsplit" else "bf16h"
            out[f"tower {TOWER_LAYERS} layers {label} B=256"] = {"out": S.digest(run(x0))}
    torch.cuda.empty_cache()
    return out


def flat(digests):
    """{"case key": digest}: ``tp_slot_split.compare``'s form."""
    return {f"{c} {k}": [v] for c, kv in digests.items() for k, v in kv.items()}


def role_of(name):
    """The entry's sub-kernel a profiler kernel name stands for."""
    if name.startswith("ln_quant_rows_kernel"):
        return "LN + quantize"
    if name.startswith("layer_norm_kernel"):
        return "LN"
    if name.startswith("qgelu_quant_rows_kernel"):
        return "gelu + quantize"
    if name.startswith("quant_rows_x4_kernel"):
        return "quantize h"
    if name.startswith("quant_rows_kernel") or name.startswith("quant_rows_wide_kernel"):
        if "bfloat16" in name:
            return "gelu + quantize" if name.rstrip(">").endswith("true") else "quantize x"
        return "quantize h"
    if name.startswith("gemm_s8_tma_kernel"):
        return "up GEMM"
    if name.startswith("gemm_s8_epi_chunk_kernel"):
        return "down GEMM"
    if name.startswith("gemm_s8_kernel<"):
        epi = name[len("gemm_s8_kernel<"):].split(",")[0].rstrip(">")
        return {"0": "up GEMM", "2": "up GEMM", "3": "up GEMM", "4": "down GEMM",
                "10": "down GEMM"}.get(epi, name)
    return name


def role_bounds(b, s, d, f, kind, k=1):
    """{sub-kernel: (ms, by)} at B, S, D, F: each launch's least time, the
    larger of its operations over the peak for their type (int8 products at
    1,979 TOP/s) and its bytes (each input read once, each output written
    once) over 3.35 TB/s.  Sizes at the model's widths (DK = D rounded up to
    64 for the codes, as the kernels write); the hidden is f32 (K4, the
    F-split) or bf16 (``kind`` "bf16h"), its row scales k a row."""
    m, dk = b * s, -(-d // 64) * 64
    hb = 2 if kind == "bf16h" else 4

    def bd(ops, nbytes):
        t_ops, t_bytes = ops / PEAK["int8"], nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")

    return {
        "LN + quantize": bd(0, m * d * 2 + m * dk + 4 * m + 8 * d),
        "LN": bd(0, m * d * 2 + m * dk * 2 + 8 * d),
        "quantize x": bd(0, m * dk * 2 + m * dk + 4 * m),
        "quantize h": bd(0, m * f * 4 + m * f + 4 * m * k),
        "gelu + quantize": bd(0, m * f * 2 + m * f + 4 * m),
        "up GEMM": bd(2 * m * d * f, m * dk + d * f + 8 * f + 4 * m + m * f * hb),
        "down GEMM": bd(2 * m * f * d, m * f + 4 * m * k + d * f + 8 * d + m * d * 2 * 2),
    }


def mlp_bound(b, s, d, f):
    """The whole entry's least time (chip_smoke.py::mlp_block_work's count:
    the two int8 products against x read and out written once, the weights,
    scales, biases and LayerNorm parameters read once)."""
    m = b * s
    t_ops = 4 * m * d * f / PEAK["int8"]
    nbytes = 2 * m * d * 2 + 2 * d * f + 2 * (f + d) * 4 + 2 * d * 4
    return max(t_ops, nbytes / HBM_BYTES_PER_S) * 1e3


def time_entry(what, fn, dims, kind, k, name, tag):
    """The split of one call: device ms per kernel (per launch, and launches
    a call), each sub-kernel's bound and share, host ms a call, 20-call
    wall.  Returns the record."""
    b, s, d, f = dims
    bounds = role_bounds(b, s, d, f, kind, k)
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
    whole = mlp_bound(b, s, d, f)
    device = f"{dev_ms:.4f} ms" if prof else "not measured (the profiler recorded no kernel)"
    print(f"{tag}{what}: device {device} a call in {launches} launches ({'; '.join(parts)}); "
          f"host {host:.4f} ms a call; 20-call wall {wall:.4f} ms (median of 5); the entry's "
          f"bound {whole:.4f} ms ({whole / wall:.1%} of the wall) ({name})", flush=True)
    return {"device": dev_ms, "host": host, "wall20": wall}


def split(fbq, dev, name, tag, own, fsplit_only=False):
    """``--split``: K4, the F-split at each SPLIT_FB and bf16h at B=256 on
    their routes and (``own``: this checkout) on the other, then the towers'
    walls (``fsplit_only``: the F-split entries alone)."""
    import torch

    case = ("split", "k4", SPLIT_B, *VIT, None, 0.5, 41)
    args, kw, x = case_block(case, dev)
    dims = (SPLIT_B, *VIT)
    f = VIT[2]
    with torch.no_grad():
        if not fsplit_only:
            time_entry(f"K4 mlp_block_q B={SPLIT_B}", lambda: fbq.mlp_block_q(x, *args, **kw),
                       dims, "k4", 1, name, tag)
        entries = [(f"F-split mlp_block_q(fb={fb})", "fsplit", fb) for fb in SPLIT_FB]
        if not fsplit_only:
            entries.append(("KB (a) 2 mlp_block_q_bf16h", "bf16h", None))
        for what, kind, fb in entries:
            k = 1 if fb is None else f // fb
            time_entry(f"{what} B={SPLIT_B}", lambda: call(fbq, kind, fb, x, args, kw), dims, kind,
                       k, name, tag)
            if own:
                time_entry(f"{what} B={SPLIT_B} on its other route",
                           lambda: call(fbq, kind, fb, x, args, kw, tma=False), dims, kind, k,
                           name, tag)
        for kind in () if fsplit_only else ("k4", "fsplit", "bf16h"):
            run, x0 = tower(fbq, dev, kind)
            ms = statistics.median(S.events_ms(lambda: run(x0), 3) for _ in range(5))
            label = {"k4": "K4", "fsplit": f"F-split fb={TOWER_FB}", "bf16h": "bf16h"}[kind]
            bound = TOWER_LAYERS * mlp_bound(SPLIT_B, *VIT)
            print(f"{tag}tower of {TOWER_LAYERS} {label} MLP halves B={SPLIT_B}: {ms:.3f} ms a "
                  f"call (3-call wall, median of 5; bound {bound:.4f} ms) ({name})", flush=True)
    del x
    torch.cuda.empty_cache()


def routes(fbq, dev, name, tag, pairs=10):
    """``--routes``: each entry at B=256 on its route and on the other,
    ``pairs`` pairs in turns (the order swapped every other pair); per route
    the median 20-call wall, and the pairs its default route won."""
    import torch

    case = ("routes", "k4", SPLIT_B, *VIT, None, 0.5, 41)
    args, kw, x = case_block(case, dev)
    for what, kind, fb in (("mlp_block_q(fb=1536)", "fsplit", 1536),
                           ("mlp_block_q(fb=1024)", "fsplit", 1024),
                           ("mlp_block_q(fb=768)", "fsplit", 768),
                           ("mlp_block_q_bf16h", "bf16h", None)):
        got = {True: [], False: []}
        for p in range(pairs):
            for tma in ((True, False) if p % 2 == 0 else (False, True)):
                got[tma].append(S.events_ms(lambda: call(fbq, kind, fb, x, args, kw, tma=tma), 20))
        won = sum(a < b for a, b in zip(got[True], got[False]))
        route = fbq.fsplit_route(VIT[1], fb) if kind == "fsplit" else "tma"
        print(f"{tag}routes {what} B={SPLIT_B}: 20-call wall {statistics.median(got[True]):.4f} "
              f"ms on its route ({route}), {statistics.median(got[False]):.4f} on the s8 GEMM "
              f"route; its route won {won} of {pairs} pairs ({name})", flush=True)
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
    ap.add_argument("--fsplit-only", action="store_true",
                    help="with --split: the F-split entries only (no K4, bf16h or towers)")
    ap.add_argument("--dump", help="write the outputs' and kernels' digests to this file")
    ap.add_argument("--against", help="compare with the digests in this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("mlp_q_split: no CUDA device found", file=sys.stderr)
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
                "gemm_s8_epi_chunk_kernel", "gemm_s8_epi_kernel", "gemm_s8_kernelILi10E",
                "qgelu_quant_rows_kernel", "quant_rows_x4_kernel", "gemm_s8_tma_kernel"))
                else None)
        elif entry and ("Used" in line or "spill" in line):
            print(f"{tag}ptxas {entry}: {line.strip()}", flush=True)

    mismatched = []

    def each(case, sk):  # this checkout: the other route gives the same outputs
        other = case_outputs(fbq, case, dev, tma=False)
        off = [k for k in KEYS[case[1]] if not torch.equal(sk[k], other[k])]
        mismatched.extend(f"{case[0]} {k}" for k in off)
        print(f"{tag}{case[0]}: the other route's outputs "
              f"{'all bit-identical' if not off else f'DIFFER: {off}'}", flush=True)

    if own:
        fbq.reset_launches()
    digests = {"outputs": {} if args.no_digests else output_digests(fbq, dev,
                                                                      each if own else None),
               "sass": sass}
    if own:
        print(f"{tag}routes taken: F-split {fbq.FSPLIT_ROUTES}, bf16h {fbq.BF16H_ROUTES}",
              flush=True)
    if args.split:
        split(fbq, dev, name, tag, own, args.fsplit_only)
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
