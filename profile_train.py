#!/usr/bin/env python3
"""Profile one training step per path of the PyTorch port on one CUDA GPU.

    python3 profile_train.py

The model, batches and trainer are ``chip_smoke.py``'s (full-width ViT-B/16
DebiasCLIP from seed 0, batch 64, the 319 generated prompts, 64 caption
tokens, TF32 off).  For each path (plain float32, K5 ``use_pallas=True``
float32, bf16 kernels) it takes 5 unprofiled steps, then one step under
``torch.profiler``, and prints:
  * the unprofiled step time (host clock, mean of steps 3-5);
  * the device kernel time of the profiled step: the sum of every kernel's
    own device time; the ``step:*`` spans that mark the step functions are
    user annotations, not kernels, and are left out of the sum;
  * the idle share, 1 - kernel time / unprofiled step time;
  * each step function's span: the device time of the kernels launched
    inside it on the calling thread (the backward runs on autograd's device
    thread, so it falls outside every span) and the span's length on the
    device;
  * the kernel time by family, and the ten longest kernels.
Exits 2 without a CUDA device.
"""

import os
import re
import sys


def family(name: str) -> str:
    n = name.lower()
    # K5: the 3xTF32 float32 kernel, the long route's kernel, or the wgmma
    # core read heads-first (attention_wgmma_kernel<NK, 1>; K1 runs it as
    # <NK, 0>)
    if ("attention_f32_kernel" in n or "attention_long_kernel" in n
            or re.search(r"attention_wgmma_kernel<\d+, 1>", n)):
        return "K5 attention kernel"
    if any(k in n for k in ("gemm_wgmma_kernel", "attention_wgmma_kernel",
                            "layer_norm_kernel")):
        return "fused-block kernels (K1/K2)"
    if "gemm" in n or "cutlass" in n or "xmma" in n:
        return "library GEMM (cuBLAS/CUTLASS)"
    if "softmax" in n:
        return "softmax"
    if "reduce" in n:
        return "reductions"
    if any(w in n for w in ("elementwise", "copy", "fill", "cat", "index")):
        return "elementwise / copies"
    return "other"


STEP_FNS = ("embed_images", "eval_scores", "adversary_step", "prompt_step")
PATHS = (("plain f32", {"use_pallas": False}), ("K5 f32", {"use_pallas": True}),
         ("bf16 kernels", {"train_dtype": "bfloat16", "embed_dtype": "bfloat16"}))


def is_span(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False)) or e.key.startswith("step:")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from debias_vision_lang_torch.eval.measure import gen_prompts
    from debias_vision_lang_torch.models.debias import DebiasCLIP
    from debias_vision_lang_torch.ops import attention as A
    from debias_vision_lang_torch.ops import fused_block as fb
    from debias_vision_lang_torch.ops import fused_block_q as fbq
    from debias_vision_lang_torch.text import ByteTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    model, _, tok, _ = DebiasCLIP.from_cfg(
        {"CLIP_ARCH": "openai/CLIP/ViT-B/16", "PRETRAINED": False,
         "NUM_DEBIAS_TOKENS": 2, "SEED": 0}, device=dev)
    tok = tok or ByteTokenizer()
    sens = tok(gen_prompts())
    cs.TRAIN_STEPS = 6
    batches = cs.train_batches(tok, model.clip_cfg.vision, dev)
    print(f"card: {cs.smi()}; torch {torch.__version__}", flush=True)

    for tag, kw in PATHS:
        run = cs.run_trainer(model, sens, batches[:5], (fb, fbq, A), **kw)
        steady = sum(run["times"][2:]) / len(run["times"][2:]) * 1e3
        tr = run["trainer"]
        for name in STEP_FNS:
            def wrapped(*a, _fn=getattr(tr.fns, name), _name=name, **k):
                with record_function("step:" + _name):
                    return _fn(*a, **k)
            setattr(tr.fns, name, wrapped)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tr.step(*batches[5])
            torch.cuda.synchronize()
        avg = prof.key_averages()
        kernels = [e for e in avg if e.device_type == DeviceType.CUDA and not is_span(e)]
        ktot = sum(e.self_device_time_total for e in kernels) / 1e3
        print(f"== {tag}: unprofiled step {steady:.1f} ms (host clock, mean of steps 3-5); "
              f"device kernel time in the profiled step {ktot:.1f} ms (spans left out); "
              f"idle share {1 - ktot / steady:.3f}")
        for e in avg:
            if e.key.startswith("step:"):
                what = ("span length on the device" if e.device_type == DeviceType.CUDA
                        else "kernels launched inside")
                print(f"   {e.key:22s} {what:26s} {e.device_time_total / 1e3:8.2f} ms "
                      f"x{e.count}")
        fam = {}
        for e in kernels:
            f = family(e.key)
            fam[f] = fam.get(f, 0.0) + e.self_device_time_total / 1e3
        for f, ms in sorted(fam.items(), key=lambda x: -x[1]):
            print(f"   family {f:32s} {ms:8.2f} ms ({ms / ktot:.1%})")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"   {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:5d}  {e.key[:100]}")
        del run, tr
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
