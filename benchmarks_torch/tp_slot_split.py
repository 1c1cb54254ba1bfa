#!/usr/bin/env python3
"""Where the time of the int8 tensor-parallel slot entries goes, on one CUDA
card: ``fused_block_q.attention_block_q_heads`` (a head group's int8
attention up to its attention rows and their row amax) and
``mlp_block_q_cols`` (a slot's hidden columns and their row amax), so that
two checkouts of the port can be compared in one run.

Cases: ViT-B/16's image tower at the main path's B=256 S=197 D=768 (12
heads, F = 3,072) split over m = 2 (6 heads, 1,536 hidden columns a slot)
and m = 8 (slots of 2 and 1 heads, 384 columns), and its causal text
tower under ``int8-text`` at B=319 S=77 D=512 (8 heads, F = 2,048) over
m = 2 and m = 8.  For each entry and case:

  * the device time of every kernel one call launches (``torch.profiler``
    over 10 calls, summed per kernel, per call);
  * the host time of one call (``time.perf_counter`` around the call, no
    synchronisation; the median of 30 calls after a warm-up);
  * the CUDA-event wall of back-to-back calls (5 calls, as chip_smoke.py's
    kernels line reads it, and 20).

With ``--towers`` also the whole int8 image tower (``QuantizedCLIP``'s
``encode_image`` on 256 uint8 staged images of a random ViT-B/16 from seed
0) unsharded and under virtual (1, 2) and (1, 8) meshes of the card (CUDA
events over 3 calls, as phase 22 reads them).

    python3 benchmarks_torch/tp_slot_split.py [--root CHECKOUT] [--label TAG]
        [--towers] [--dump FILE] [--against FILE]

``--root`` imports ``debias_vision_lang_torch`` from another checkout (a
parent commit unpacked with ``git archive``); its kernels build under that
checkout.  ``--dump`` writes to FILE (JSON) the sha256 of every
entry's outputs (rows or hidden, and amax), of K3's and K4's outputs on the
same inputs, and of the SASS of every kernel of the int8 library
(``cuobjdump``, addresses, encodings and the anonymous namespace's hashes
stripped); ``--against`` compares this run's with such a file (the design
before the slots' redesign: ``benchmarks_torch/tp_slot_parent.json``):
outputs bit for bit, and which kernels of the library were added, removed
or compiled otherwise.  Prints the card's
nvidia-smi name and power limit.  Exits 2 without a card, 1 if an output
or a kernel differs under ``--against``.
"""

import argparse
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (label, B, S, D, heads, causal, model slots m, [slot j of each timed
# head group], slot of the timed hidden columns, weight seed)
CASES = (("ViT-B/16 m=2", 256, 197, 768, 12, False, 2, [0], 0, 7),
         ("ViT-B/16 m=8", 256, 197, 768, 12, False, 8, [1, 0], 3, 7),
         ("text m=2", 319, 77, 512, 8, True, 2, [0], 0, 11),
         ("text m=8", 319, 77, 512, 8, True, 8, [0], 3, 11))


# the anonymous namespace's mangled name, which holds hashes of the
# translation unit (it may move with any edit of the source)
ANON = re.compile(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def digest(t) -> str:
    import torch

    raw = t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def sass_digests(path) -> dict:
    """{mangled kernel name: sha256 of its SASS} of one library, each
    instruction's address comment and encoding stripped; {} without
    cuobjdump."""
    sys.path.insert(1, HERE)
    import chip_smoke

    funcs = chip_smoke.sass_functions(path) or {}
    out = {}
    for name, body in funcs.items():
        text = ANON.sub("<anon>", re.sub(r"/\*[^*]*\*/", "", body))
        text = "\n".join(" ".join(line.split()) for line in text.splitlines() if line.strip())
        out[ANON.sub("<anon>", name)] = hashlib.sha256(text.encode()).hexdigest()[:16]
    return out


def events_ms(fn, iters):
    import torch

    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def host_ms(fn, calls=30):
    """The median host time of one call, no synchronisation between calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(calls):
        t = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(ts)


def kernel_split(fn, iters=10, tries=3):
    """[(kernel, ms per launch)] of one call's device kernels, in launch
    order (each launched once a call; per launch, since the profiler may
    drop some calls' events).  Late in a long process the profiler can
    record no kernel at all: up to ``tries`` profiles; [] if none did."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", 0) or 0
            if us > 0:
                m = re.match(r"^(?:void )?(?:\(anonymous namespace\)::)?(\w+)(<[^(]*>)?", ev.key)
                name = (m.group(1) + re.sub(r"\s+", "", m.group(2) or "")) if m else ev.key
                out.append((name, us / max(ev.count, 1) / 1e3))
        if out:
            break
    return out


def time_entry(what, fn, name):
    split = kernel_split(fn)
    dev = sum(ms for _, ms in split)
    host = host_ms(fn)
    w5, w20 = events_ms(fn, 5), events_ms(fn, 20)
    device = (f"{dev:.4f} ms ({'; '.join(f'{k} {v:.4f}' for k, v in split)})" if split
              else "not measured (the profiler recorded no kernel)")
    print(f"{what}: device {device}; "
          f"host {host:.4f} ms a call; event wall {w5:.4f} ms (5 calls), {w20:.4f} (20) "
          f"({name})", flush=True)
    return {"device": dev, "split": split, "host": host, "wall5": w5, "wall20": w20}


def towers(device, name, tag):
    """The int8 ViT-B/16 image tower at B=256, unsharded and under (1, 2)
    and (1, 8) virtual meshes of the card: ms per call, and whether each
    split tower's rows are bit-equal to the unsharded ones."""
    import torch
    from debias_vision_lang_torch.models.debias import DebiasCLIP
    from debias_vision_lang_torch.ops.quant import QuantizedCLIP
    from debias_vision_lang_torch.parallel import mesh as pmesh

    model, _, _, _ = DebiasCLIP.from_cfg(
        {"CLIP_ARCH": "openai/CLIP/ViT-B/16", "PRETRAINED": False, "NUM_DEBIAS_TOKENS": 2,
         "DEBIAS_POS": "prepend", "SEED": 0}, device=device)
    model.eval()
    vis = model.clip_cfg.vision
    n = (vis.image_size // vis.patch_size) ** 2
    g = torch.Generator(device=device).manual_seed(25)
    p8 = torch.randint(0, 256, (256, n, vis.patch_size ** 2 * 3), generator=g, device=device,
                       dtype=torch.uint8)
    with torch.no_grad():
        q = QuantizedCLIP(model)
        one = q.encode_image(p8)
        res = {"unsharded": events_ms(lambda: q.encode_image(p8), 3)}
        for shape in ((1, 2), (1, 8)):
            mesh = pmesh.create_mesh(shape, devices=[device] * (shape[0] * shape[1]))
            qt = pmesh.shard_quantized_clip(q, mesh)
            same = torch.equal(qt.encode_image(p8), one)
            res[str(shape)] = events_ms(lambda: qt.encode_image(p8), 3)
            print(f"{tag}int8 image tower B=256 {shape}: {res[str(shape)]:.3f} ms, rows "
                  f"{'bit-equal to' if same else 'DIFFER from'} the unsharded tower "
                  f"({res['unsharded']:.3f} ms) ({name})", flush=True)
            del qt
    return res


def case_tensors(case, dev):
    """One case's seeded inputs: x and a block's int8 weights (``QWeight``)."""
    import torch
    from debias_vision_lang_torch.ops.quant import QWeight

    _, b, s, d, *_, seed = case
    f = 4 * d
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * std

    t = {"ln_1": (1 + 0.1 * rn(d), 0.1 * rn(d))}
    t["wqkv"], t["bqkv"] = QWeight(rn(d, 3 * d, std=d ** -0.5)), 0.1 * rn(3 * d)
    t["wo"], t["bo"] = QWeight(rn(d, d, std=d ** -0.5)), 0.1 * rn(d)
    t["ln_2"] = (1 + 0.1 * rn(d), 0.1 * rn(d))
    t["w1"], t["b1"] = QWeight(rn(d, f, std=(2 * d) ** -0.5)), 0.1 * rn(f)
    t["w2"], t["b2"] = QWeight(rn(f, d, std=f ** -0.5)), 0.1 * rn(d)
    t["x"] = rn(b, s, d).to(torch.bfloat16)
    return t


def case_calls(fbq, case, t):
    """[(key, call)]: K3 and K4 on the case's x (at m = 2 only: once a
    shape), each timed head group's slot entry, the hidden columns' slot
    entry.  Each call returns a tuple of the outputs to digest."""
    from debias_vision_lang_torch.parallel.tensor import head_columns, head_group

    label, b, s, d, heads, causal, m, slots, hslot, _ = case
    f = 4 * d
    x, (ls, lb), (l2s, l2b) = t["x"], t["ln_1"], t["ln_2"]
    wqkv, wo, w1, w2 = t["wqkv"], t["wo"], t["w1"], t["w2"]
    calls = []
    if m == 2:
        calls.append((f"{label} K3", lambda: (fbq.attention_block_q(
            x, ls, lb, wqkv.q, wqkv.scale, t["bqkv"], wo.q, wo.scale, t["bo"], heads=heads,
            causal=causal, wqkv_qt=wqkv.qt, wo_qt=wo.qt),)))
        calls.append((f"{label} K4", lambda: (fbq.mlp_block_q(
            x, l2s, l2b, w1.q, w1.scale, t["b1"], w2.q, w2.scale, t["b2"], w1_qt=w1.qt,
            w2_qt=w2.qt),)))
    for j in slots:
        lo, hi = head_group(heads, m, j)
        cols = head_columns(d, m, j, heads).to(x.device)
        wq, wsc, bq = wqkv.q[:, cols], wqkv.scale[:, cols], t["bqkv"][cols]
        wqt = wq.t().contiguous()
        calls.append((f"{label} attention_block_q_heads g={hi - lo}",
                      lambda wq=wq, wsc=wsc, wqt=wqt, bq=bq, g=hi - lo:
                      fbq.attention_block_q_heads(x, ls, lb, wq, wsc, bq, heads=g, causal=causal,
                                                  wqkv_qt=wqt)))
    hid = slice(hslot * f // m, (hslot + 1) * f // m)
    w1q, w1s, b1j = w1.q[:, hid], w1.scale[:, hid], t["b1"][hid]
    w1t = w1q.t().contiguous()
    calls.append((f"{label} mlp_block_q_cols F/m={f // m}",
                  lambda: fbq.mlp_block_q_cols(x, l2s, l2b, w1q, w1s, b1j, w1_qt=w1t)))
    return calls


def output_digests(fbq, cases, dev, each=None):
    """{key: [digest of each output]} over ``cases``; ``each(key, call)`` runs
    after each call's digests (the timing)."""
    import torch

    out = {}
    for case in cases:
        t = case_tensors(case, dev)
        for key, call in case_calls(fbq, case, t):
            out[key] = [digest(o) for o in call()]
            if each is not None and "K3" not in key and "K4" not in key:
                causal = case[5] and "attention" in key
                each(f"{key} B={case[1]} S={case[2]} D={case[3]}{' causal' if causal else ''}",
                     call)
        del t
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE, help="the checkout whose port is timed")
    ap.add_argument("--label", default="", help="a tag printed on every line")
    ap.add_argument("--towers", action="store_true", help="also time the whole int8 towers")
    ap.add_argument("--dump", help="write the outputs' and kernels' digests to this file")
    ap.add_argument("--against", help="compare with the digests in this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("tp_slot_split: no CUDA device found", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from debias_vision_lang_torch.ops import _build
    from debias_vision_lang_torch.ops import fused_block_q as fbq

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    name = card()
    tag = f"{args.label} " if args.label else ""
    fbq.build()
    digests = {"sass": sass_digests(_build.LIB_PATHS["fused_block_q"])}
    print(f"{tag}int8 library: {len(digests['sass'])} kernels in its SASS")
    digests["outputs"] = output_digests(
        fbq, CASES, dev, lambda what, call: time_entry(f"{tag}{what}", call, name))
    if args.towers:
        towers(dev, name, tag)
    if args.dump:
        os.makedirs(os.path.dirname(os.path.abspath(args.dump)), exist_ok=True)
        with open(args.dump, "w") as fh:
            json.dump(digests, fh, indent=1, sort_keys=True)
    if not args.against:
        return 0
    with open(args.against) as fh:
        theirs = json.load(fh)
    bad = compare(digests, theirs, args.against, tag)
    return 1 if bad else 0


def compare(mine, theirs, where, tag=""):
    """Print which outputs are bit-identical to ``theirs`` and which kernels
    of the int8 library were added, removed or compiled otherwise; returns
    the number of outputs that differ plus the kernels compiled otherwise."""
    bad = 0
    for k, v in sorted(mine["outputs"].items()):
        same = theirs["outputs"].get(k) == v
        bad += not same
        print(f"{tag}{k}: {'bit-identical to' if same else 'DIFFERS from'} {where}")
    new, old = mine["sass"], theirs["sass"]
    added, removed = sorted(set(new) - set(old)), sorted(set(old) - set(new))
    changed = sorted(k for k in set(new) & set(old) if new[k] != old[k])
    print(f"{tag}int8 library against {where}: {len(set(new) & set(old))} kernels in both, "
          f"{len(changed)} compiled otherwise {changed}; added {added}; removed {removed}")
    return bad + len(changed)


if __name__ == "__main__":
    sys.exit(main())
