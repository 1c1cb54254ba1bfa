"""Command-line interface (the port's ``debias_vision_lang_tpu/cli.py``).

    python -m debias_vision_lang_torch measure-bias --model openai/CLIP/ViT-B/16 --dtype bfloat16
    python -m debias_vision_lang_torch train --arch openai/CLIP/ViT-B/16 --epochs 5
    python -m debias_vision_lang_torch serve --random-weights --dtype bfloat16
    python -m debias_vision_lang_torch zero-shot --data-path DIR --dtype bfloat16

The subcommands take the JAX CLI's arguments, defaults and choices, plus
``--device`` (default ``cuda``; without a card it raises, nothing moves to
the CPU on its own).  ``download`` and ``bench`` keep their parsers, so
``--help`` lists the same commands, and exit naming the ``ROADMAP.md``
entry that holds them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROADMAP_DOWNLOAD = ("ROADMAP.md 'Not to port' (downloads): the port fetches nothing; "
                    "put files in place, or point the paths' environment variables "
                    "at them")
ROADMAP_BENCH = "ROADMAP.md queue 1 item 9 (the port's bench, a benchmark issue)"


def _parse_topn(s: str):
    """Dispatch on the literal's type: '1000' → absolute k (int), '0.5' or
    '1.0' → dataset fraction (float).  '--topn 1' means top-1; '--topn 2.5'
    is rejected (a fraction must be ≤ 1.0, an absolute k must be integral)."""
    try:
        v = int(s)
    except ValueError:
        try:
            v = float(s)
        except ValueError:
            raise argparse.ArgumentTypeError(f"invalid topn: {s!r}")
        if not 0.0 < v <= 1.0:
            raise argparse.ArgumentTypeError(
                f"fractional topn must be in (0, 1]; for an absolute top-k "
                f"pass an integer literal (got {s!r})")
        return v
    if v < 1:
        raise argparse.ArgumentTypeError(f"absolute topn must be >= 1 (got {s!r})")
    return v


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device: the card (default) or 'cpu'")


def _add_measure(sub):
    p = sub.add_parser("measure-bias", help="MaxSkew/NDKL on FairFace or UTKFace")
    p.add_argument("--model", default="openai/CLIP/ViT-B/16",
                   help="registry name (or 'hub:ViT-B/16-gender')")
    p.add_argument("--attribute", default="gender",
                   choices=["gender", "race", "age"])
    p.add_argument("--dataset", default="fairface", choices=["fairface", "utkface"])
    p.add_argument("--data-path", default=None)
    p.add_argument("--topn", default="1.0", type=_parse_topn,
                   help="integer literal = absolute top-k (e.g. 1000, incl. "
                        "1); float literal = dataset fraction (e.g. 0.5, "
                        "1.0 = whole set) — matches resolve_topn semantics")
    p.add_argument("--batch-size", default=256, type=int)
    p.add_argument("--engine", default="tpu", choices=["tpu", "oracle"],
                   help="'tpu' = the device ranking engine (the JAX CLI's "
                        "name for it), 'oracle' = the numpy oracle")
    p.add_argument("--dtype", default=None,
                   choices=["float32", "bfloat16", "int8", "int8-text", "auto"],
                   help="embedding precision: float32 = reference parity "
                        "(the default, with a hint on the card), bfloat16/"
                        "int8 = the kernels' rungs, auto = the fastest "
                        "measured rung per model family (rank-stable)")
    p.add_argument("--random-weights", action="store_true",
                   help="skip pretrained weight resolution")
    p.add_argument("--mesh", default=None, choices=[None, "auto"],
                   help="'auto' = split the embed pass over all visible "
                        "cards (and, under torchrun, every rank's)")
    p.add_argument("--sharded-metrics", action="store_true",
                   help="rank the embeddings sharded: per-shard top-k + "
                        "exact merge (requires --mesh auto)")
    p.add_argument("--cache-embeddings", default=None,
                   help="path: cache image embeddings so prompt/topn "
                        "re-runs skip the tower pass")
    p.add_argument("--n-samples", default=None, type=int,
                   help="subsample the dataset (reference _n_samples)")
    _add_device(p)


def _hub_model(name: str, device):
    """``hub:<name or path>`` → (model, preprocess, tokenizer or None)."""
    from .hub import load
    from .text.tokenizer import load_tokenizer

    model, preprocess = load(name, device=device)
    try:
        tokenizer = load_tokenizer()
    except FileNotFoundError:
        tokenizer = None  # each command says what a missing vocab means
    return model, preprocess, tokenizer


def _cmd_measure(args):
    if args.sharded_metrics and args.mesh is None:
        sys.exit("--sharded-metrics requires --mesh auto")
    from .eval.measure import measure_bias

    if args.model.startswith("hub:"):
        model, preprocess, tokenizer = _hub_model(args.model[4:], args.device)
    else:
        from .models.loader import model_loader

        model, preprocess, tokenizer, _ = model_loader(
            args.model, device=args.device, pretrained=not args.random_weights)
    if tokenizer is None:
        sys.exit("No BPE vocab available: put bpe_simple_vocab_16e6.txt.gz in "
                 "the assets directory or set $DEBIAS_VLT_BPE_PATH")
    opts = {"topn": args.topn, "batch_size": args.batch_size,
            "engine": args.engine, "dataset": args.dataset,
            "data_path": args.data_path, "progress": True}
    if args.dtype is not None:
        opts["dtype"] = args.dtype
    if args.mesh:
        opts["mesh"] = args.mesh
    if args.sharded_metrics:
        opts["sharded_metrics"] = True
    if args.cache_embeddings:
        opts["cache_embeddings"] = args.cache_embeddings
    if args.n_samples is not None:
        opts["n_samples"] = args.n_samples
    result = measure_bias(model, preprocess, tokenizer,
                          attribute=args.attribute, opts=opts)
    print(json.dumps(result, indent=2))


def _add_train(sub):
    p = sub.add_parser("train", help="adversarial prompt-array debias training")
    p.add_argument("--arch", default="openai/CLIP/ViT-B/16")
    p.add_argument("--attribute", default="gender")
    p.add_argument("--num-debias-tokens", default=2, type=int)
    p.add_argument("--debias-pos", default="prepend")
    p.add_argument("--epochs", default=5, type=int)
    p.add_argument("--batch-size", default=64, type=int)
    p.add_argument("--pairs-path", required=False, default=None,
                   help="image-caption pairs dir (flickr30k-style) for the "
                        "contrastive loss; omitted → FairFace images with "
                        "generated prompts as weak pairs")
    p.add_argument("--data-path", default=None, help="FairFace root")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--eval-every", default=500, type=int)
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--mesh", default=None, choices=[None, "auto"],
                   help="'auto' = data-parallel image embeds over all "
                        "visible cards (batches split over the data axis)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --checkpoint-dir")
    p.add_argument("--embed-dtype", default="float32",
                   choices=["float32", "bfloat16", "int8"],
                   help="frozen image-tower precision: bfloat16/int8 run the "
                        "fused-block kernels for the no-gradient embed pass "
                        "(differentiable steps stay fp32)")
    p.add_argument("--train-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="differentiable text-tower precision (mixed "
                        "precision: prompt array, grads, losses and the "
                        "adversary stay fp32)")
    p.add_argument("--approx-frozen-scores", action="store_true",
                   help="OPT-IN approximation for vid-layer/unfrozen-proj "
                        "training: the adversarial-score term keeps image "
                        "embeddings frozen (saves one image fwd+bwd per "
                        "step; CHANGES GRADIENTS — see "
                        "TrainConfig.approx_frozen_scores)")
    p.add_argument("--lr-schedule", default="constant",
                   choices=["constant", "cosine", "warmup_cosine"],
                   help="LR schedule for both optimizers; cosine horizon "
                        "defaults to epochs x steps-per-epoch")
    p.add_argument("--warmup-steps", default=0, type=int,
                   help="linear LR warmup steps (warmup_cosine)")
    p.add_argument("--decay-steps", default=None, type=int,
                   help="cosine horizon override in optimizer steps")
    p.add_argument("--grad-clip-norm", default=None, type=float,
                   help="global-norm gradient clipping before adam")
    p.add_argument("--no-embed-cache", action="store_true",
                   help="disable the frozen-embedding cache (frozen-image "
                        "configs embed the train rows + caption corpus once "
                        "and train epochs from cached rows; this flag forces "
                        "the per-step decode+embed path)")
    p.add_argument("--embed-cache-dir", default=None,
                   help="persist the once-embedded rows to this directory, "
                        "content-fingerprinted (tower weights, dataset "
                        "rows, captions, dtype) — repeated runs over the "
                        "same frozen tower + data skip the decode+embed pass")
    _add_device(p)


def _cmd_train(args):
    from .train.loop import run_training

    best = run_training(
        arch=args.arch,
        attribute=args.attribute,
        num_debias_tokens=args.num_debias_tokens,
        debias_pos=args.debias_pos,
        epochs=args.epochs,
        batch_size=args.batch_size,
        pairs_path=args.pairs_path,
        data_path=args.data_path,
        checkpoint_dir=args.checkpoint_dir,
        eval_every=args.eval_every,
        pretrained=not args.random_weights,
        mesh=args.mesh,
        resume=args.resume,
        embed_dtype=args.embed_dtype,
        train_dtype=args.train_dtype,
        approx_frozen_scores=args.approx_frozen_scores,
        lr_schedule=args.lr_schedule,
        warmup_steps=args.warmup_steps,
        decay_steps=args.decay_steps,
        grad_clip_norm=args.grad_clip_norm,
        cache_frozen_embeddings=not args.no_embed_cache,
        embedding_cache_dir=args.embed_cache_dir,
        device=args.device,
    )
    print(json.dumps(best, indent=2))


def _add_zero_shot(sub):
    p = sub.add_parser("zero-shot", help="zero-shot classification accuracy")
    p.add_argument("--model", default="openai/CLIP/ViT-B/16")
    p.add_argument("--data-path", required=True,
                   help="directory layout: class-name subdirs of images")
    p.add_argument("--batch-size", default=256, type=int)
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--imagenet-protocol", action="store_true",
                   help="use the full 80-template OpenAI ImageNet protocol")
    p.add_argument("--dtype", default=None,
                   choices=["float32", "bfloat16", "int8", "int8-text", "auto"],
                   help="vision-tower precision (default float32 = reference "
                        "parity; bfloat16 / int8 = the kernels' rungs; "
                        "int8-text also runs the classifier text encodes "
                        "int8; auto = the fastest measured rung per model "
                        "family)")
    _add_device(p)


class FolderDataset:
    """Class-folder images: each subdirectory of ``root`` is a class (sorted
    by name), every file in it an image of that class."""

    def __init__(self, root):
        self.files, labels = [], []
        self.class_names = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        for ci, cname in enumerate(self.class_names):
            for f in sorted(os.listdir(os.path.join(root, cname))):
                self.files.append(os.path.join(root, cname, f))
                labels.append(ci)
        self.iat_labels = np.asarray(labels)

    def __len__(self):
        return len(self.files)

    def load_image(self, i):
        from PIL import Image

        with Image.open(self.files[i]) as im:
            return np.asarray(im.convert("RGB"))

    @property
    def _img_fnames(self):  # lets HostLoader take the native batch ingest
        return self.files


def _cmd_zero_shot(args):
    from .data.loader import HostLoader
    from .eval.zero_shot import imagenet_templates, zero_shot_accuracy
    from .models.loader import model_loader

    model, preprocess, tokenizer, _ = model_loader(
        args.model, device=args.device, pretrained=not args.random_weights)
    if tokenizer is None:
        sys.exit("No BPE vocab available: put bpe_simple_vocab_16e6.txt.gz in "
                 "the assets directory or set $DEBIAS_VLT_BPE_PATH")
    # the input resolution is the model's (e.g. RN50x4 is 288 px)
    n_px = getattr(preprocess, "n_px", 224)
    ds = FolderDataset(args.data_path)
    loader = HostLoader(ds, batch_size=args.batch_size, native_n_px=n_px)
    kw = {"templates": imagenet_templates()} if args.imagenet_protocol else {}
    acc = zero_shot_accuracy(model, tokenizer, loader, ds.class_names,
                             n_px=n_px, progress=True, dtype=args.dtype, **kw)
    print(json.dumps(acc, indent=2))


def _add_serve(sub):
    p = sub.add_parser("serve", help="batched HTTP inference server")
    p.add_argument("--model", default="openai/CLIP/ViT-B/16",
                   help="registry name (or 'hub:ViT-B/16-gender')")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", default=8000, type=int)
    p.add_argument("--max-batch", default=64, type=int,
                   help="device batch bucket ceiling (power-of-two padding)")
    p.add_argument("--max-wait-ms", default=5.0, type=float,
                   help="micro-batch arrival window")
    p.add_argument("--dtype", default=None,
                   choices=[None, "float32", "bfloat16", "int8", "int8-text", "auto"],
                   help="compute dtype (default: bfloat16 on the card, "
                        "float32 on the CPU; int8 = quantized vision tower; "
                        "int8-text also quantizes the text tower; auto = the "
                        "fastest measured rung per model family)")
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip running every batch bucket at startup")
    p.add_argument("--mesh", default=None, choices=[None, "auto"],
                   help="'auto' = one process splitting every batch over "
                        "all visible cards")
    p.add_argument("--auth-token", default=None,
                   help="require 'Authorization: Bearer <token>' on data "
                        "endpoints (default: $DVL_SERVE_TOKEN if set, "
                        "else open; /healthz stays open for LB probes)")
    p.add_argument("--tls-cert", default=None,
                   help="PEM certificate chain — serve HTTPS directly "
                        "(for production prefer a fronting LB/proxy)")
    p.add_argument("--tls-key", default=None,
                   help="PEM private key (defaults to --tls-cert file)")
    p.add_argument("--reuse-port", action="store_true",
                   help="bind with SO_REUSEPORT: run several serve "
                        "processes on ONE port (one per card, each with "
                        "its own visible devices) and let the kernel "
                        "balance connections")
    _add_device(p)


def _cmd_serve(args):
    from .serve import serve_forever

    if args.model.startswith("hub:"):
        model, _, tokenizer = _hub_model(args.model[4:], args.device)
    else:
        from .models.loader import model_loader

        model, _, tokenizer, _ = model_loader(
            args.model, device=args.device, pretrained=not args.random_weights)
    if tokenizer is None:
        # image endpoints still serve; text endpoints report the missing
        # vocab per request
        print("warning: no BPE vocab; text endpoints disabled", file=sys.stderr)
    serve_forever(model, tokenizer, host=args.host, port=args.port,
                  max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                  compute_dtype=args.dtype, warmup=not args.no_warmup,
                  mesh=args.mesh, auth_token=args.auth_token,
                  tls_cert=args.tls_cert, tls_key=args.tls_key,
                  reuse_port=args.reuse_port, device=args.device)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="debias-vlt-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_measure(sub)
    _add_train(sub)
    _add_zero_shot(sub)
    _add_serve(sub)
    dl = sub.add_parser("download", help="fetch assets (bpe, fairface)")
    dl.add_argument("assets", nargs="*", default=["all"])
    sub.add_parser("bench", help="run the headline throughput benchmark")

    args = parser.parse_args(argv)
    if args.cmd in ("measure-bias", "train", "zero-shot", "serve"):
        from .parallel.mesh import init_distributed

        # a no-op unless a coordinator is named ($MASTER_ADDR under
        # torchrun): then every rank's slots join one mesh and `--mesh auto`
        # spans them
        init_distributed()
    if args.cmd == "measure-bias":
        _cmd_measure(args)
    elif args.cmd == "train":
        _cmd_train(args)
    elif args.cmd == "serve":
        _cmd_serve(args)
    elif args.cmd == "zero-shot":
        _cmd_zero_shot(args)
    elif args.cmd == "download":
        sys.exit(f"download is not ported: {ROADMAP_DOWNLOAD}")
    elif args.cmd == "bench":
        sys.exit(f"bench is not ported yet: {ROADMAP_BENCH}")


if __name__ == "__main__":
    main()
