"""Shared set-up of the port's KB runners (``attn_int8_cores.py``,
``q_mlp_bf16h.py``, ``q_kernel_variants.py``, ``attn_variants.py``,
``q_ilp.py``, ``q_layer_fused.py``, ``q_attribution.py`` in this
directory): the card, the kernels, the phase-4 model's resblocks (as they are for the bf16 blocks,
quantized by the port's ``quantize_resblocks`` for the int8 ones), the
scripts' inputs and their timing loop."""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def setup(name: str, float_blocks: bool = False):
    """(chip_smoke, ops.fused_block_q, the 12 quantized ViT-B/16 resblocks,
    the card's nvidia-smi line); with ``float_blocks`` (chip_smoke,
    ops.fused_block, the 12 resblocks as they are, the card's line).  Exits
    2 without a card."""
    import torch

    if not torch.cuda.is_available():
        print(f"{name}: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from debias_vision_lang_torch.models.debias import DebiasCLIP
    from debias_vision_lang_torch.ops import _build
    from debias_vision_lang_torch.ops import fused_block as fb
    from debias_vision_lang_torch.ops import fused_block_q as fbq
    from debias_vision_lang_torch.ops.quant import quantize_resblocks

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = C.smi()
    _build.load_all(["fused_block" if float_blocks else "fused_block_q"])
    model, _, _, _ = DebiasCLIP.from_cfg(
        {"CLIP_ARCH": "openai/CLIP/ViT-B/16", "PRETRAINED": False, "NUM_DEBIAS_TOKENS": 2,
         "DEBIAS_POS": "prepend", "SEED": 0}, device=torch.device("cuda"))
    model.eval()
    if float_blocks:
        blocks = model.clip.visual.resblocks
        print(f"card: {card}; {len(blocks)} ViT-B/16 resblocks (seed 0)", flush=True)
        return C, fb, blocks, card
    blocks = quantize_resblocks(model.clip.visual.resblocks)
    del model
    print(f"card: {card}; {len(blocks)} quantized ViT-B/16 resblocks (seed 0)", flush=True)
    return C, fbq, blocks, card


def timeit(fn, bufs, steps):
    """ms per call of ``fn`` over ``steps`` calls alternating the input
    buffers, after one warm-up call on each (the scripts' ``timeit``), with
    CUDA events."""
    import torch

    fn(bufs[0])
    fn(bufs[1])
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(steps):
        fn(bufs[i % 2])
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / steps


def emit(**kv):
    print(json.dumps(kv), flush=True)
