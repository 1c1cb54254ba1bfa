"""Batched inference engine behind the serving API.

Counterpart of ``debias_vision_lang_tpu/serve/engine.py``.  Every device
call runs at a power-of-two batch bucket (pad with zeros, slice the
results), so a server sees at most log2(max_batch)+1 shapes per entry point
ever, and ``warmup`` builds the kernels before the first request.
Host-side image decode rides the port's native C++ ingest when it is built
(bit-exact PIL chain) and PIL otherwise: host decode, not a device path.

The engine wraps a CLIP or DebiasCLIP bundle, moved once to ``device`` (the
card unless ``device="cpu"``).  On a CUDA device the bfloat16 rung runs the
fused-block kernels (``ops/fused_block.py``) and the int8 rungs the int8
ones (``ops/fused_block_q.py``); a kernel's failure reaches the caller.
Two threads launch into one model (the image and the text batchers'
workers): ``self._lock`` serialises the host-to-device copy and the
launch, which touch the fused blocks' weight copies and launch counters
(each dispatch stages into a buffer of its own first).  Batches are staged
in pinned host memory and copied without blocking, so the launch of batch
k+1 queues behind batch k on the stream instead of waiting for it;
PyTorch's pinned-memory allocator reuses a staging block only after its
copy has completed.  Every launch goes to the thread's current stream,
the default stream unless a caller sets another, so a fetch on the
batcher's finalizer thread is ordered after the launch it reads.
"""

from __future__ import annotations

import io
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.clip import VIT_KINDS
from ..ops.quant import resolve_compute
from ..utils.device import resolve_device
from ..vision.preprocess import preprocess_batch, resize_crop_u8, to_rgb_array

ROADMAP_DISTRIBUTION = "ROADMAP.md queue 1 item 5 (distribution)"


def _pow2_ceil(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


def _next_bucket(n: int, max_batch: int) -> int:
    """Smallest power-of-two bucket holding n (callers chunk to max_batch,
    which __init__ normalizes to a power of two, so this never exceeds it)."""
    return min(_pow2_ceil(n), max_batch)


def _model_stats(model):
    """The tower's normalization stats from the bundle's config."""
    cfg = getattr(model, "clip_cfg", None) or getattr(model, "cfg", None)
    if cfg is None:
        return {}
    return {"mean": cfg.vision.image_mean, "std": cfg.vision.image_std}


@torch.inference_mode()
def _embed_images_u8(model, images_u8: torch.Tensor, compute_dtype) -> torch.Tensor:
    if images_u8.dim() == 3:
        # patch-contiguous uint8 staging [B, P, patch²·3]: encode_image takes
        # the folded stem (models/clip.py::is_patch_staging), no preprocess
        return model.encode_image(images_u8, dtype=compute_dtype).float()
    x = preprocess_batch(images_u8, images_u8.shape[1], **_model_stats(model))
    return model.encode_image(x, dtype=compute_dtype).float()


@torch.inference_mode()
def _embed_texts(model, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    return model.encode_text(tokens, dtype=compute_dtype).float()


# per-image pixel ceiling (≈ 0.2 GB decoded RGB).  PIL's decompression-bomb
# guard does not cover the native libjpeg path, whose output buffer is sized
# from attacker-controlled header dimensions — a ~300 KB crafted 65500²
# JPEG would otherwise allocate ~12.8 GB from one record.
MAX_DECODE_PIXELS = 64 * 1024 * 1024


def decode_image_bytes(data: bytes) -> np.ndarray:
    """Image bytes (JPEG/PNG/...) → uint8 [H, W, 3] RGB.

    Native libjpeg decode when built (bit-exact vs PIL) — that path never
    touches PIL, header to pixels; PIL handles everything else, parsed
    once.  Dimensions are checked against ``MAX_DECODE_PIXELS`` from the
    header BEFORE any pixel decode (both libjpeg's header reader and
    ``Image.open`` size images without decoding)."""
    from .. import native

    if data[:2] == b"\xff\xd8" and native.available():  # JPEG magic
        try:
            h, w = native.jpeg_dims(data)
        except ValueError:
            h = w = None  # exotic variant → PIL below
        if h is not None:
            if w * h > MAX_DECODE_PIXELS:
                raise ValueError(
                    f"image {w}x{h} exceeds the {MAX_DECODE_PIXELS}-pixel "
                    "decode limit")
            try:
                return native.decode_jpeg(data, dims=(h, w))
            except ValueError:
                pass  # fall through to PIL for exotic variants

    from PIL import Image

    try:
        im = Image.open(io.BytesIO(data))
        w, h = im.size
    except Image.DecompressionBombError as e:
        # PIL's own guard (a plain Exception, not OSError) fires during the
        # header parse for extreme sizes — same client-error class as ours
        raise ValueError(str(e)) from e
    if w * h > MAX_DECODE_PIXELS:
        raise ValueError(
            f"image {w}x{h} exceeds the {MAX_DECODE_PIXELS}-pixel "
            "decode limit")
    return to_rgb_array(im)


class InferenceEngine:
    """Thread-safe batched embed/score front-end over a model bundle."""

    def __init__(
        self,
        model,
        tokenizer=None,
        max_batch: int = 64,
        compute_dtype: Optional[str] = None,
        mesh=None,
        device="cuda",
    ):
        """``device``: where the model runs, the card unless ``"cpu"``
        (without a card the default raises).  ``compute_dtype``: a rung of
        ``ops/quant.resolve_compute``; by default bfloat16 on a CUDA device
        and float32 on the CPU.  ``mesh`` (multi-device serving) is not
        ported and raises."""
        if mesh is not None:
            raise NotImplementedError(
                f"mesh serving is not ported yet: {ROADMAP_DISTRIBUTION}")
        self.device = resolve_device(device)
        if compute_dtype is None:
            compute_dtype = ("bfloat16" if self.device.type == "cuda"
                             else "float32")
        self.precision = str(compute_dtype)
        # the port's one precision-ladder policy: "int8" wraps the bundle in
        # QuantizedCLIP (on the device, so the int8 weights are made there),
        # bf16/f32 pass through, "auto" and unknown strings raise
        model, compute_dtype = resolve_compute(model.to(self.device),
                                               self.precision)
        self.model = model
        self.tokenizer = tokenizer
        cfg = getattr(model, "clip_cfg", None) or model.cfg
        self.cfg = cfg
        self.n_px = cfg.vision.image_size
        self.embed_dim = cfg.embed_dim
        self.context_length = cfg.text.context_length
        # normalize to a power of two so the warmup bucket set and the
        # runtime bucket cap are the same closed set
        self.max_batch = _pow2_ceil(int(max_batch))
        self.compute_dtype = compute_dtype
        # patch-contiguous uint8 staging (same policy as eval/measure.py):
        # a ViT at its native resolution on the bf16/int8 rungs stages
        # batches host-side so the stem is one matmul with the normalize
        # folded into the weights; float32 keeps the preprocess + patch
        # stem (reference-parity mode)
        self._patch = None
        if (cfg.vision.kind in VIT_KINDS and compute_dtype == torch.bfloat16
                and self.n_px % cfg.vision.patch_size == 0):
            self._patch = cfg.vision.patch_size
        self._pin = self.device.type == "cuda"
        self._lock = threading.Lock()
        # params are frozen for the engine's lifetime: read logit_scale once
        # instead of a blocking device→host fetch on every score() call
        scale = self.model.logit_scale.detach().float().cpu().numpy()
        self._score_scale = float(np.exp(scale))

    # -- batch entry points (called by the micro-batcher) --------------------

    def _staging(self, shape, dtype) -> torch.Tensor:
        """A zeroed host tensor for one bucket, pinned on a CUDA device."""
        return torch.zeros(shape, dtype=dtype, pin_memory=self._pin)

    def _launch(self, embed, staged: torch.Tensor) -> torch.Tensor:
        """Copy a staged bucket to the device and launch, under the lock."""
        with self._lock:
            x = staged.to(self.device, non_blocking=True)
            return embed(self.model, x, self.compute_dtype)

    def dispatch_image_arrays(self, images_u8: Sequence[np.ndarray]):
        """Stage + launch: uint8 arrays → device tensor handle, unsynchronised.

        Pair with ``fetch`` on another thread (the batcher's finalizer),
        which blocks for the result."""
        n = len(images_u8)
        if n > self.max_batch:
            raise ValueError(f"dispatch of {n} items exceeds max_batch="
                             f"{self.max_batch}; chunk first "
                             "(embed_image_arrays does)")
        bucket = _next_bucket(n, self.max_batch)
        if self._patch is not None:
            # staged bucket [bucket, P, patch²·3]: items may arrive
            # pre-patchified (the native raw-JPEG ingest emits the staging
            # layout directly at decode time — prepare_images_batch) or as
            # HWC frames, each reordered straight into the staging buffer
            # (one strided copy; patchify_u8's layout)
            p = self._patch
            g = self.n_px // p
            pp, dd = g * g, p * p * 3
            staged = self._staging((bucket, pp, dd), torch.uint8)
            batch = staged.numpy()
            for i, img in enumerate(images_u8):
                if img.shape == (pp, dd):
                    batch[i] = img
                elif img.shape == (self.n_px, self.n_px, 3):
                    batch[i].reshape(g, g, p, p * 3)[...] = (
                        img.reshape(g, p, g, p * 3).transpose(0, 2, 1, 3))
                else:
                    raise ValueError(
                        f"image {i}: expected ({self.n_px},{self.n_px},3) "
                        f"or staged ({pp},{dd}), got {img.shape}")
        else:
            staged = self._staging((bucket, self.n_px, self.n_px, 3), torch.uint8)
            batch = staged.numpy()
            for i, img in enumerate(images_u8):
                if img.shape != (self.n_px, self.n_px, 3):
                    raise ValueError(
                        f"image {i}: expected "
                        f"({self.n_px},{self.n_px},3), got {img.shape}")
                batch[i] = img
        return self._launch(_embed_images_u8, staged)

    def dispatch_token_arrays(self, tokens: Sequence[np.ndarray]):
        """Stage + launch: token id rows → device tensor handle."""
        n = len(tokens)
        if n > self.max_batch:
            raise ValueError(f"dispatch of {n} items exceeds max_batch="
                             f"{self.max_batch}; chunk first "
                             "(embed_token_arrays does)")
        bucket = _next_bucket(n, self.max_batch)
        staged = self._staging((bucket, self.context_length), torch.int64)
        batch = staged.numpy()
        for i, row in enumerate(tokens):
            batch[i] = row
        return self._launch(_embed_texts, staged)

    @staticmethod
    def fetch(handle: torch.Tensor, n: int) -> np.ndarray:
        """Block for the device result and strip bucket padding."""
        return handle[:n].cpu().numpy()

    def _chunked(self, dispatch, items) -> np.ndarray:
        """Run >max_batch inputs as a pipeline of max_batch dispatches
        (launch them all, then fetch in order)."""
        if not items:
            return np.zeros((0, self.embed_dim), np.float32)
        chunks = [items[i:i + self.max_batch]
                  for i in range(0, len(items), self.max_batch)]
        handles = [(dispatch(c), len(c)) for c in chunks]
        return np.concatenate([self.fetch(h, n) for h, n in handles])

    def embed_image_arrays(self, images_u8: Sequence[np.ndarray]) -> np.ndarray:
        """uint8 [n_px, n_px, 3] arrays → float32 [N, D] embeddings
        (inputs beyond max_batch are chunked into bucket-sized launches)."""
        return self._chunked(self.dispatch_image_arrays, list(images_u8))

    def embed_token_arrays(self, tokens: Sequence[np.ndarray]) -> np.ndarray:
        """Token id rows [context_length] → float32 [N, D] embeddings
        (chunked like embed_image_arrays)."""
        return self._chunked(self.dispatch_token_arrays, list(tokens))

    def warmup(self, log=None) -> None:
        """Run every batch bucket of both modalities once.

        A serving process must not pay first-use costs under load: the
        first launch builds the CUDA kernels (``ops/_build.py``, nvcc when
        the cached build is stale) and each fused block's K-major weight
        copies, and the first decode builds the native ingest (or finds it
        cannot), so trigger them all before any request arrives."""
        from .. import native

        native.available()
        b = 1
        while True:
            if log:
                log(f"warmup: bucket {b}")
            if self._patch is not None:
                g = self.n_px // self._patch
                imgs = torch.zeros((b, g * g, self._patch ** 2 * 3), dtype=torch.uint8)
            else:
                imgs = torch.zeros((b, self.n_px, self.n_px, 3), dtype=torch.uint8)
            toks = torch.zeros((b, self.context_length), dtype=torch.int64)
            self.fetch(self._launch(_embed_images_u8, imgs), b)
            self.fetch(self._launch(_embed_texts, toks), b)
            if b >= self.max_batch:
                break
            b <<= 1

    # -- host-side conveniences ---------------------------------------------

    def prepare_image(self, data: bytes) -> np.ndarray:
        """bytes → decoded + bit-exact-PIL resize/crop uint8 [n_px, n_px, 3]."""
        return resize_crop_u8(decode_image_bytes(data), self.n_px)

    def prepare_images_batch(self, records: Sequence[bytes]) -> list:
        """Decode + bit-exact resize/crop a WHOLE request's encoded images
        in one threaded native call (the raw-JPEG serving path).

        JPEG/PNG records ride ``native.ingest_batch_mem_u8[p]`` — decode,
        PIL-exact short-side resize, center crop, and (on the staged bf16/
        int8 rungs) the patch-contiguous relayout, all inside the C++
        thread pool with the per-image pixel cap enforced from the header.
        Anything else (exotic formats, no native build) takes the
        per-record Python chain, preserving PIL's format coverage.  Raises
        ValueError naming the first undecodable/oversized record."""
        from .. import native

        out: list = [None] * len(records)
        nat_idx = []
        if native.available():
            nat_idx = [i for i, r in enumerate(records)
                       if r[:2] == b"\xff\xd8" or r[:8] == b"\x89PNG\r\n\x1a\n"]
        if nat_idx:
            blobs = [records[i] for i in nat_idx]
            if self._patch is not None:
                arr, ok = native.ingest_batch_mem_u8p(
                    blobs, self.n_px, self._patch,
                    max_pixels=MAX_DECODE_PIXELS)
            else:
                arr, ok = native.ingest_batch_mem_u8(
                    blobs, self.n_px, max_pixels=MAX_DECODE_PIXELS)
            if not ok.all():
                bad = nat_idx[int(np.flatnonzero(~ok)[0])]
                raise ValueError(
                    f"undecodable or oversized image record {bad}")
            for j, i in enumerate(nat_idx):
                out[i] = arr[j]
        for i, r in enumerate(records):
            if out[i] is None:
                try:
                    out[i] = self.prepare_image(r)
                except OSError as e:
                    # PIL raises UnidentifiedImageError/OSError on corrupt
                    # bytes; a bad client payload must 400, not 500
                    raise ValueError(
                        f"undecodable image record {i}: {e}") from e
        return out

    def tokenize(self, texts: List[str]) -> np.ndarray:
        if self.tokenizer is None:
            raise RuntimeError("engine built without a tokenizer "
                               "(BPE vocab missing?)")
        return np.asarray(self.tokenizer(texts), np.int64)

    def score(self, image_embs: np.ndarray, text_embs: np.ndarray) -> np.ndarray:
        """Softmaxed logits-per-image (the reference README flow,
        reference: README.md:57-64): [N_img, N_txt] probabilities."""
        img = image_embs / np.linalg.norm(image_embs, axis=-1, keepdims=True)
        txt = text_embs / np.linalg.norm(text_embs, axis=-1, keepdims=True)
        logits = self._score_scale * img @ txt.T
        e = np.exp(logits - logits.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    def info(self) -> dict:
        cuda = self.device.type == "cuda"
        return {
            "model": self.cfg.name,
            "n_px": self.n_px,
            "embed_dim": self.embed_dim,
            "context_length": self.context_length,
            "compute_dtype": str(self.compute_dtype).replace("torch.", ""),
            "precision": self.precision,
            "max_batch": self.max_batch,
            "backend": self.device.type,
            "device_name": torch.cuda.get_device_name(self.device) if cuda else "cpu",
            "has_tokenizer": self.tokenizer is not None,
            "mesh": None,
            "device_memory": _device_memory(self.device) if cuda else None,
        }


def _device_memory(device: torch.device) -> list:
    """The card's memory: what this process's tensors hold, and what is free
    of the card's total."""
    free, total = torch.cuda.mem_get_info(device)
    return [{"device": str(device),
             "bytes_in_use": torch.cuda.memory_allocated(device),
             "bytes_free": free,
             "bytes_limit": total}]
