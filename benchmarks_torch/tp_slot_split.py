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
the GEMM route, ten pairs in turns (``route_pairs``); with ``--rows --routes``
the same for ``rows_q_partial``'s strip cases (``rows_route_pairs``).

With ``--rows`` the row-parallel product ``fused_block_q.rows_q_partial``
alone (the slots' quantize at the maxed amaxes and int32 product), in place
of the slot entries, in every case a tower runs (``ROW_CASES``: the
attention half's bf16 rows and the MLP half's f32 hidden, each at its
slot's K, with the m slots' real amaxes), and beside each ``torch._int_mm``
on the same codes (a yardstick for the product alone, on no path) and the
bytes bound; it digests the codes, row scales and partials.  With ``--towers``
also the whole image tower (int8: ``QuantizedCLIP``'s ``encode_image``;
bf16: ``encode_image`` at bfloat16) on 256 uint8 staged images of a
random ViT-B/16 from seed 0, unsharded and under virtual (1, 2) and (1, 8)
meshes of the card (CUDA events over 3 calls, as phase 22 reads them, the
median of 5 such runs), and each split tower's device time by kernel
(``torch.profiler`` over 2 calls).

    python3 benchmarks_torch/tp_slot_split.py [--bf16 | --rows] [--root CHECKOUT]
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
``benchmarks_torch/tp_slot_parent.json``, int8, ``tp_slot_bf16_parent.json``,
bf16, and ``tp_rows_parent.json``, ``--rows``): outputs bit for bit, and which kernels
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
# ``--rows``: (label, B, S, D, heads, m, half, slot j, input dtype, seed); the
# attention half's input is slot j's bf16 rows (its head group's g hd
# columns of the D-wide row), the MLP half's its f32 hidden (F / m of F)
ROW_CASES = (("ViT-B/16 m=2 attention g=6", 256, 197, 768, 12, 2, "attention", 0, "bf16", 31),
             ("ViT-B/16 m=2 MLP Fj=1536", 256, 197, 768, 12, 2, "mlp", 0, "f32", 32),
             ("ViT-B/16 m=8 attention g=2", 256, 197, 768, 12, 8, "attention", 1, "bf16", 33),
             ("ViT-B/16 m=8 attention g=1", 256, 197, 768, 12, 8, "attention", 0, "bf16", 33),
             ("ViT-B/16 m=8 MLP Fj=384", 256, 197, 768, 12, 8, "mlp", 3, "f32", 34),
             ("text m=2 attention g=4", 319, 77, 512, 8, 2, "attention", 0, "bf16", 35),
             ("text m=2 MLP Fj=1024", 319, 77, 512, 8, 2, "mlp", 0, "f32", 36),
             ("text m=8 attention g=1", 319, 77, 512, 8, 8, "attention", 0, "bf16", 37),
             ("text m=8 MLP Fj=256", 319, 77, 512, 8, 8, "mlp", 3, "f32", 38))
HBM_BYTES_PER_S = 3.35e12  # chip_smoke.py's memory rate of the card


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


def sass_digests(path, sass=None) -> dict:
    """{mangled kernel name: sha256 of its SASS} of one library (its
    cuobjdump dump, or ``sass`` where the caller has it, split at each
    "Function :" header), each instruction's address comment and encoding
    stripped; {} without cuobjdump."""
    if sass is None:
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


def profiled(fn, iters, tries=1):
    """[(kernel, device ms summed over the calls, launches)] of ``iters``
    calls of ``fn`` under ``torch.profiler``.  Late in a long process the
    profiler can record no kernel at all: up to ``tries`` profiles; [] if
    none did."""
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
                out.append((name, us / 1e3, max(ev.count, 1)))
        if out:
            break
    return out


def kernel_split(fn, iters=10, tries=3):
    """[(kernel, ms per launch)] of one call's device kernels, in launch
    order (each launched once a call; per launch, since the profiler may
    drop some calls' events)."""
    return [(name, ms / n) for name, ms, n in profiled(fn, iters, tries)]


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


def tower_ms(fn):
    """A tower's CUDA-event wall: 3 calls, the median of 5 such runs."""
    return statistics.median(events_ms(fn, 3) for _ in range(5))


def tower_kernels(fn, iters=2):
    """[(ms a call, launches a call, kernel)] of a tower's device kernels,
    most time first."""
    return sorted(((ms / iters, n // iters, name) for name, ms, n in profiled(fn, iters)),
                  reverse=True)


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
        res = {"unsharded": tower_ms(lambda: enc(q))}
        for shape in ((1, 2), (1, 8)):
            mesh = pmesh.create_mesh(shape, devices=[device] * (shape[0] * shape[1]))
            qt = (pmesh.shard_clip_params if bf16 else pmesh.shard_quantized_clip)(q, mesh)
            got = enc(qt)
            if bf16:
                cos = torch.nn.functional.cosine_similarity(got.float(), one.float(), dim=-1)
                same = f"at cosine min {cos.min().item():.7f} with"
            else:
                same = "bit-equal to" if torch.equal(got, one) else "DIFFER from"
            res[str(shape)] = tower_ms(lambda: enc(qt))
            kernels = tower_kernels(lambda: enc(qt))
            most = "; ".join(f"{k} {ms:.3f} ({n})" for ms, n, k in kernels[:6])
            print(f"{tag}{'bf16' if bf16 else 'int8'} image tower B=256 {shape}: "
                  f"{res[str(shape)]:.3f} ms, rows {same} the unsharded tower "
                  f"({res['unsharded']:.3f} ms); device {sum(ms for ms, _, _ in kernels):.3f} ms "
                  f"a call (most: {most}) ({name})", flush=True)
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


def rows_bytes(mm, k, n, m, a_bytes):
    """rows_q_partial's bytes (chip_smoke.py::tp_rows_q_work): the input
    [M, K] read, m amaxes, codes and scales written, the weight read, the
    int32 [M, N] partial written."""
    return mm * k * a_bytes + 4 * mm * m + mm * k + 4 * mm + k * n + 4 * mm * n


def rows_inputs(case, dev):
    """One ``--rows`` case's seeded inputs: (a, the m slots' row amaxes, the
    weight rows w_q [K, D] int8 and their transpose w_qt).  The whole row
    (D wide for the attention half, F for the MLP half) is drawn on the
    card; slot j's columns are ``a``, every slot's columns give an amax."""
    import torch
    from debias_vision_lang_torch.parallel.tensor import head_group

    _, b, s, d, heads, m, half, j, dt, seed = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    hd = d // heads
    if half == "attention":
        whole = (torch.randn(b, s, d, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        bounds = [tuple(hd * h for h in head_group(heads, m, i)) for i in range(m)]
    else:
        h = torch.randn(b, s, 4 * d, generator=gen, device=dev)
        whole = h * torch.sigmoid(1.702 * h)
        bounds = [(i * 4 * d // m, (i + 1) * 4 * d // m) for i in range(m)]
    amaxes = [whole[..., lo:hi].float().abs().amax(-1, keepdim=True)
              for lo, hi in bounds if hi > lo]
    lo, hi = bounds[j]
    a = whole[..., lo:hi].contiguous()
    w_q = torch.randint(-127, 128, (hi - lo, d), generator=gen, device=dev, dtype=torch.int8)
    return a, amaxes, w_q, w_q.t().contiguous()


def rows_calls(fbq, dev):
    """(key, call, (a, w_qt, bytes)) of each ``--rows`` case in turn (its
    inputs made when it comes up): each runs ``rows_q_partial`` (codes, row
    scales, int32 partial)."""
    for case in ROW_CASES:
        label, b, s, d, _, m, *_ = case
        a, amaxes, w_q, w_qt = rows_inputs(case, dev)
        k = a.shape[-1]
        nbytes = rows_bytes(b * s, k, d, len(amaxes), a.element_size())
        key = f"{label} rows_q_partial K={k} {str(a.dtype)[6:]} B={b} S={s} D={d}"
        yield (key, lambda a=a, amaxes=amaxes, w_q=w_q, w_qt=w_qt:
               fbq.rows_q_partial(a, amaxes, w_q, w_qt=w_qt), (a, w_qt, nbytes))


def rows_split(fbq, dev, name, tag, each=None):
    """{key: [digest of each output]} of the ``--rows`` cases; ``each(key,
    call)`` times each, and beside it ``torch._int_mm`` on the call's codes
    and the bytes bound."""
    import torch

    out = {}
    for key, call, (a, w_qt, nbytes) in rows_calls(fbq, dev):
        got = call()
        out[key] = [digest(o) for o in got]
        if each is None:
            continue
        each(key, call)
        aq = got[1].reshape(-1, got[1].shape[-1])

        def int_mm():
            return torch._int_mm(aq, w_qt.t())

        try:
            same = torch.equal(int_mm(), got[0].reshape(aq.shape[0], -1))
            ms = statistics.median(events_ms(int_mm, 20) for _ in range(5))
            lib = (f"{ms:.4f} ms (20-call wall, median of 5; "
                   f"{'the same' if same else 'NOT the same'} int32)")
        except RuntimeError as e:
            lib = f"refused ({str(e).splitlines()[0][:80]})"
        print(f"{tag}{key}: bytes bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms "
              f"({nbytes / 1e6:.1f} MB); torch._int_mm on its codes {lib} ({name})", flush=True)
        del got, aq, call, a, w_qt, int_mm
        torch.cuda.empty_cache()
    return out


def rows_route_pairs(fbq, dev, name, tag, pairs=10):
    """The host work of ``rows_q_partial``'s routes, in one process: each
    ``--rows`` case the row-strip kernel takes, on its route and on the
    quantize pass + GEMM route (``strip=False``) in turns, ``pairs`` times,
    alternating which runs first; per route the median host time of a call
    and of the 20-call event wall, and the pairs whose wall the strip won.
    This checkout's entry only (not ``--root``)."""
    import torch

    for case in ROW_CASES:
        a, amaxes, _, w_qt = rows_inputs(case, dev)
        if fbq.rows_route(a.shape[-1], w_qt.shape[0]) != "strip":
            continue
        key = f"{case[0]} K={a.shape[-1]} {str(a.dtype)[6:]}"
        got = {True: ([], []), False: ([], [])}
        for p in range(pairs):
            for strip in ((True, False) if p % 2 == 0 else (False, True)):
                call = lambda strip=strip: fbq._rows_q_partial_cuda(  # noqa: E731
                    a, amaxes, w_qt, None, strip=strip)
                host, wall = got[strip]
                host.append(host_ms(call))
                wall.append(events_ms(call, 20))
        won = sum(x < y for x, y in zip(got[True][1], got[False][1]))
        med = {k: (statistics.median(h), statistics.median(w)) for k, (h, w) in got.items()}
        print(f"{tag}routes {key}: host a call {med[True][0]:.4f} ms on the strip, "
              f"{med[False][0]:.4f} on the quantize pass + GEMM; 20-call wall {med[True][1]:.4f} / "
              f"{med[False][1]:.4f} ms, the strip won {won} of {pairs} pairs ({name})", flush=True)
        del a, amaxes, w_qt
        torch.cuda.empty_cache()


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
    ap.add_argument("--rows", action="store_true",
                    help="rows_q_partial alone in every case a tower runs (not the slot entries)")
    ap.add_argument("--towers", action="store_true", help="also time the whole towers")
    ap.add_argument("--routes", action="store_true",
                    help="with --bf16 (the m = 8 slots) or --rows (the strip cases): the host "
                         "time on each route, in turns")
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
    timed = lambda what, call: time_entry(f"{tag}{what}", call, name)  # noqa: E731
    if args.rows and not args.bf16:
        digests["outputs"] = rows_split(fbq, dev, name, tag, timed)
    else:
        digests["outputs"] = output_digests(lib, CASES, dev, timed, bf16=args.bf16,
                                            blocks=args.blocks)
    if args.towers:
        towers(dev, name, tag, bf16=args.bf16)
    if args.routes and args.bf16:
        route_pairs(fb, dev, name, tag)
    elif args.routes and args.rows:
        rows_route_pairs(fbq, dev, name, tag)
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
