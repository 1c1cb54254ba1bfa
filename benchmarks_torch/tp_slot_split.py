#!/usr/bin/env python3
"""Where the time of the tensor-parallel slot entries goes, on one CUDA
card: the int8 ones, ``fused_block_q.attention_block_q_heads`` (a head
group's int8 attention up to its attention rows and their row amax) and
``mlp_block_q_cols`` (a slot's hidden columns and their row amax), or with
``--bf16`` the bf16 ones, ``fused_block.attention_block_heads`` (a head
group's f32 partial of the block) and ``mlp_block_cols`` (a slot's hidden
columns' f32 partial), so that two checkouts of the port can be compared in
one run.

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
    kernels line reads it, and 20: the median of 5 such runs).

With ``--blocks`` also the unsharded blocks on the case's x, the same way
(int8: K3 and K4; bf16: K1, K2 and ``tp_reduce`` of m copies of the timed
slot's partial).  With ``--bf16 --routes`` also the host work the
row-strip route adds a call: the m = 8 slot entries on their route and on
the GEMM route, ten pairs in turns (``route_pairs``).  With ``--towers``
also the whole image tower (int8: ``QuantizedCLIP``'s ``encode_image``;
bf16: ``encode_image`` at bfloat16) on 256 uint8 staged images of a
random ViT-B/16 from seed 0, unsharded and under virtual (1, 2) and (1, 8)
meshes of the card (CUDA events over 3 calls, as phase 22 reads them).

    python3 benchmarks_torch/tp_slot_split.py [--bf16] [--root CHECKOUT]
        [--label TAG] [--blocks] [--towers] [--routes] [--dump FILE] [--against FILE]

``--root`` imports ``debias_vision_lang_torch`` from another checkout (a
parent commit unpacked with ``git archive``); its kernels build under that
checkout.  ``--dump`` writes to FILE (JSON) the sha256 of every
entry's outputs (int8: rows or hidden, and amax, and K3's and K4's outputs
on the same inputs; bf16: the partials, and K1's, K2's and KB (a) 6's
outputs, whole and on each timed head group), and of the SASS of every
kernel of the entries' library (``cuobjdump``, addresses, encodings and the
anonymous namespace's hashes stripped); ``--against`` compares this run's
with such a file (the designs before the slots' redesigns:
``benchmarks_torch/tp_slot_parent.json``, int8, and
``tp_slot_bf16_parent.json``, bf16): outputs bit for bit, and which kernels
of the library were added, removed or compiled otherwise.  Prints the card's
nvidia-smi name and power limit.  Exits 2 without a card, 1 if an output
or a kernel differs under ``--against``.
"""

import argparse
import hashlib
import json
import math
import os
import re
import shutil
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
    """{mangled kernel name: sha256 of its SASS} of one library (its
    cuobjdump dump split at each "Function :" header), each instruction's
    address comment and encoding stripped; {} without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = part.split("\n", 1)[0].strip(), part
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
    w5, w20 = events_ms(fn, 5), statistics.median(events_ms(fn, 20) for _ in range(5))
    device = (f"{dev:.4f} ms ({'; '.join(f'{k} {v:.4f}' for k, v in split)})" if split
              else "not measured (the profiler recorded no kernel)")
    print(f"{what}: device {device}; "
          f"host {host:.4f} ms a call; event wall {w5:.4f} ms (5 calls), {w20:.4f} (20, median "
          f"of 5 runs) "
          f"({name})", flush=True)
    return {"device": dev, "split": split, "host": host, "wall5": w5, "wall20": w20}


def towers(device, name, tag, bf16=False):
    """The int8 (or ``bf16``) ViT-B/16 image tower at B=256, unsharded and
    under (1, 2) and (1, 8) virtual meshes of the card: ms per call, and
    whether each split tower's rows are bit-equal to the unsharded ones
    (bf16: their cosine with them, the split sums the slots' partials)."""
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
        if bf16:
            q = model
            enc = lambda mdl: mdl.encode_image(p8, dtype=torch.bfloat16)  # noqa: E731
        else:
            q = QuantizedCLIP(model)
            enc = lambda mdl: mdl.encode_image(p8)  # noqa: E731
        one = enc(q)
        res = {"unsharded": events_ms(lambda: enc(q), 3)}
        for shape in ((1, 2), (1, 8)):
            mesh = pmesh.create_mesh(shape, devices=[device] * (shape[0] * shape[1]))
            qt = (pmesh.shard_clip_params if bf16 else pmesh.shard_quantized_clip)(q, mesh)
            got = enc(qt)
            if bf16:
                cos = torch.nn.functional.cosine_similarity(got.float(), one.float(), dim=-1)
                same = f"at cosine min {cos.min().item():.7f} with"
            else:
                same = "bit-equal to" if torch.equal(got, one) else "DIFFER from"
            res[str(shape)] = events_ms(lambda: enc(qt), 3)
            print(f"{tag}{'bf16' if bf16 else 'int8'} image tower B=256 {shape}: "
                  f"{res[str(shape)]:.3f} ms, rows {same} the unsharded tower "
                  f"({res['unsharded']:.3f} ms) ({name})", flush=True)
            del qt
    return res


def case_tensors(case, dev):
    """One case's seeded inputs: x and a block's int8 weights (``QWeight``),
    their f32 draws under ``"f32"``."""
    import torch
    from debias_vision_lang_torch.ops.quant import QWeight

    _, b, s, d, *_, seed = case
    f = 4 * d
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * std

    t = {"ln_1": (1 + 0.1 * rn(d), 0.1 * rn(d)), "f32": {}}

    def weight(key, *shape, std):
        t["f32"][key] = rn(*shape, std=std)
        return QWeight(t["f32"][key])

    t["wqkv"], t["bqkv"] = weight("wqkv", d, 3 * d, std=d ** -0.5), 0.1 * rn(3 * d)
    t["wo"], t["bo"] = weight("wo", d, d, std=d ** -0.5), 0.1 * rn(d)
    t["ln_2"] = (1 + 0.1 * rn(d), 0.1 * rn(d))
    t["w1"], t["b1"] = weight("w1", d, f, std=(2 * d) ** -0.5), 0.1 * rn(f)
    t["w2"], t["b2"] = weight("w2", f, d, std=f ** -0.5), 0.1 * rn(d)
    t["x"] = rn(b, s, d).to(torch.bfloat16)
    return t


def hgrid_operands(attn, heads):
    """KB (a) 6's operands from a block's (ln_s, ln_b, wqkv, bqkv, wo, bo), as
    benchmarks/attn_variants.py's main() builds them: q columns pre-scaled by
    hd^-0.5 log2 e, per-head [D, 3 hd] blocks (bf16), wo as [H hd, D] (bf16).
    Built here, not by the port, so that every checkout ``--root`` names gets
    the same operands."""
    import torch

    ls, lb, wqkv, bqkv, wo, bo = attn
    d = wo.shape[0]
    hd = d // heads
    scale = hd ** -0.5 * math.log2(math.e)
    wq = torch.cat([wqkv[:, :d] * scale, wqkv[:, d:]], dim=1)
    bq = torch.cat([bqkv[:d] * scale, bqkv[d:]])
    wqkv_h = torch.stack([torch.cat([wq[:, i * d + h * hd:i * d + (h + 1) * hd]
                                     for i in range(3)], dim=1) for h in range(heads)])
    bqkv_h = torch.stack([torch.cat([bq[i * d + h * hd:i * d + (h + 1) * hd] for i in range(3)])
                          for h in range(heads)])
    return (ls, lb, wqkv_h.to(torch.bfloat16), bqkv_h, wo.to(torch.bfloat16), bo)


def slot_args(case, t):
    """The bf16 slot entries' arguments on the case's f32 draws: [(lo, hi,
    (ln_s, ln_b, wqkv_g, bqkv_g, wo_g))] of each timed head group [lo, hi),
    and (ln_s, ln_b, w1_j, b1_j, w2_j) of the timed hidden columns."""
    from debias_vision_lang_torch.parallel.tensor import head_columns, head_group

    _, b, s, d, heads, causal, m, slots, hslot, _ = case
    f, hd = 4 * d, d // heads
    (ls, lb), (l2s, l2b) = t["ln_1"], t["ln_2"]
    wqkv, wo, w1, w2 = (t["f32"][k] for k in ("wqkv", "wo", "w1", "w2"))
    groups = []
    for j in slots:
        lo, hi = head_group(heads, m, j)
        cols = head_columns(d, m, j, heads).to(wqkv.device)
        groups.append((lo, hi, (ls, lb, wqkv[:, cols].contiguous(), t["bqkv"][cols].contiguous(),
                                wo[lo * hd:hi * hd].contiguous())))
    hid = slice(hslot * f // m, (hslot + 1) * f // m)
    return groups, (l2s, l2b, w1[:, hid].contiguous(), t["b1"][hid].contiguous(),
                    w2[hid].contiguous())


def case_calls_bf16(fb, case, t, blocks=False):
    """[(key, call)] of the bf16 entries: K1, K2 and KB (a) 6 on the case's x
    (at m = 2 only: once a shape), each timed head group's slot entry and
    KB (a) 6's partial of the same heads, the hidden columns' slot entry,
    and with ``blocks`` ``tp_reduce`` of m copies of the last timed head
    group's partial.  The weights are the int8 cases' f32 draws (x too)."""
    label, b, s, d, heads, causal, m, slots, hslot, _ = case
    f = 4 * d
    x, (ls, lb), (l2s, l2b) = t["x"], t["ln_1"], t["ln_2"]
    wqkv, wo, w1, w2 = (t["f32"][k] for k in ("wqkv", "wo", "w1", "w2"))
    attn = (ls, lb, wqkv, t["bqkv"], wo, t["bo"])
    kb = hgrid_operands(attn, heads)
    calls = []
    if m == 2:
        calls.append((f"{label} K1", lambda: (fb.attention_block(x, *attn, heads=heads,
                                                                 causal=causal),)))
        calls.append((f"{label} K2", lambda: (fb.mlp_block(x, l2s, l2b, w1, t["b1"], w2,
                                                           t["b2"]),)))
        if not causal:
            calls.append((f"{label} KB (a) 6", lambda: (fb.attention_block_hgrid(
                x, *kb, heads=heads),)))
    groups, gm = slot_args(case, t)
    last = None
    for lo, hi, ga in groups:
        last = ga, hi - lo
        calls.append((f"{label} attention_block_heads g={hi - lo}",
                      lambda ga=ga, g=hi - lo: (fb.attention_block_heads(x, *ga, heads=g,
                                                                         causal=causal),)))
        if not causal:
            calls.append((f"{label} KB (a) 6 heads [{lo}, {hi})",
                          lambda lo=lo, g=hi - lo: (fb.attention_block_hgrid(
                              x, *kb, heads=heads, h0=lo, g=g),)))
    calls.append((f"{label} mlp_block_cols F/m={f // m}", lambda: (fb.mlp_block_cols(x, *gm),)))
    if blocks:
        ga, g = last
        part = fb.attention_block_heads(x, *ga, heads=g, causal=causal)
        parts = [part] + [part.clone() for _ in range(m - 1)]
        calls.append((f"{label} tp_reduce of {m}", lambda: (fb.tp_reduce(
            parts, t["bo"], x, bias_first=False),)))
    return calls


def route_pairs(fb, dev, name, tag, pairs=10):
    """The host work the row-strip route adds to a call, in one process: each
    m = 8 case's bf16 slot entries on their route and on the GEMM route
    (``strip=False``, the launches of the design before it) in turns,
    ``pairs`` times, alternating which runs first; per route the median host
    time of a call and of the 20-call event wall, and the pairs whose wall
    the route won.  This checkout's entries only (not ``--root``)."""
    import torch

    for case in CASES:
        label, b, s, d, heads, causal, m, *_ = case
        if m != 8:
            continue
        t = case_tensors(case, dev)
        x = t["x"]
        groups, gm = slot_args(case, t)
        entries = [(f"attention_block_heads g={hi - lo}", fb.group_plan(d, d // heads, hi - lo).da,
                    lambda strip, ga=ga, g=hi - lo: fb._heads_cuda(x, *ga, g, causal, strip=strip))
                   for lo, hi, ga in groups]
        entries.append((f"mlp_block_cols F/m={4 * d // m}", fb.mlp_plan(d, 4 * d // m).fp,
                        lambda strip: fb._mlp_cols_cuda(x, *gm, "quick_gelu", strip=strip)))
        for what, k, call in entries:
            got = {True: ([], []), False: ([], [])}
            for p in range(pairs):
                for strip in ((True, False) if p % 2 == 0 else (False, True)):
                    host, wall = got[strip]
                    host.append(host_ms(lambda: call(strip)))
                    wall.append(events_ms(lambda: call(strip), 20))
            won = sum(a < b for a, b in zip(got[True][1], got[False][1]))
            med = {k: (statistics.median(h), statistics.median(w)) for k, (h, w) in got.items()}
            print(f"{tag}routes {label} {what} B={b} S={s} D={d}: host a call "
                  f"{med[True][0]:.4f} ms on its route ({fb.slot_route(k, d)}), "
                  f"{med[False][0]:.4f} on the GEMM route; 20-call wall {med[True][1]:.4f} / "
                  f"{med[False][1]:.4f} ms, won {won} of {pairs} pairs ({name})", flush=True)
        del t
        torch.cuda.empty_cache()


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


# the unsharded blocks and KB (a) 6: digested, timed only with ``blocks``
BLOCK_KEYS = (" K1", " K2", " K3", " K4", " KB (a) 6", " tp_reduce")


def output_digests(lib, cases, dev, each=None, bf16=False, blocks=False):
    """{key: [digest of each output]} over ``cases`` (``lib`` fused_block_q,
    or with ``bf16`` fused_block); ``each(key, call)`` runs after each
    call's digests (the timing), on the blocks only with ``blocks``."""
    import torch

    out = {}
    for case in cases:
        t = case_tensors(case, dev)
        calls = case_calls_bf16(lib, case, t, blocks) if bf16 else case_calls(lib, case, t)
        for key, call in calls:
            out[key] = [digest(o) for o in call()]
            block = any(k in key for k in BLOCK_KEYS)
            if each is not None and (blocks or not block) and "KB (a) 6" not in key:
                causal = case[5] and ("attention" in key or " K1" in key)
                each(f"{key} B={case[1]} S={case[2]} D={case[3]}{' causal' if causal else ''}",
                     call)
        del t
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE, help="the checkout whose port is timed")
    ap.add_argument("--label", default="", help="a tag printed on every line")
    ap.add_argument("--bf16", action="store_true", help="the bf16 slot entries (not int8)")
    ap.add_argument("--blocks", action="store_true",
                    help="also time the unsharded blocks (and bf16 tp_reduce)")
    ap.add_argument("--towers", action="store_true", help="also time the whole towers")
    ap.add_argument("--routes", action="store_true",
                    help="with --bf16: the m = 8 slots' host time on each route, in turns")
    ap.add_argument("--dump", help="write the outputs' and kernels' digests to this file")
    ap.add_argument("--against", help="compare with the digests in this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("tp_slot_split: no CUDA device found", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from debias_vision_lang_torch.ops import _build
    from debias_vision_lang_torch.ops import fused_block as fb
    from debias_vision_lang_torch.ops import fused_block_q as fbq

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    name = card()
    tag = f"{args.label} " if args.label else ""
    lib, kind = (fb, "fused_block") if args.bf16 else (fbq, "fused_block_q")
    lib.build()
    digests = {"sass": sass_digests(_build.LIB_PATHS[kind])}
    print(f"{tag}{kind} library: {len(digests['sass'])} kernels in its SASS ({name})")
    digests["outputs"] = output_digests(
        lib, CASES, dev, lambda what, call: time_entry(f"{tag}{what}", call, name),
        bf16=args.bf16, blocks=args.blocks)
    if args.towers:
        towers(dev, name, tag, bf16=args.bf16)
    if args.routes and args.bf16:
        route_pairs(fb, dev, name, tag)
    if args.dump:
        os.makedirs(os.path.dirname(os.path.abspath(args.dump)), exist_ok=True)
        with open(args.dump, "w") as fh:
            json.dump(digests, fh, indent=1, sort_keys=True)
    if not args.against:
        return 0
    with open(args.against) as fh:
        theirs = json.load(fh)
    bad = compare(digests, theirs, args.against, tag, kind)
    return 1 if bad else 0


def compare(mine, theirs, where, tag="", kind="fused_block_q"):
    """Print which outputs are bit-identical to ``theirs`` and which kernels
    of the library were added, removed or compiled otherwise; returns the
    number of outputs that differ plus the kernels compiled otherwise."""
    bad = 0
    for k, v in sorted(mine["outputs"].items()):
        same = theirs["outputs"].get(k) == v
        bad += not same
        print(f"{tag}{k}: {'bit-identical to' if same else 'DIFFERS from'} {where}")
    new, old = mine["sass"], theirs["sass"]
    added, removed = sorted(set(new) - set(old)), sorted(set(old) - set(new))
    changed = sorted(k for k in set(new) & set(old) if new[k] != old[k])
    print(f"{tag}{kind} library against {where}: {len(set(new) & set(old))} kernels in both, "
          f"{len(changed)} compiled otherwise {changed}; added {added}; removed {removed}")
    return bad + len(changed)


if __name__ == "__main__":
    sys.exit(main())
