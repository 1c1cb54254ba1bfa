#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. the card's name and power limit, torch / CUDA versions, optional hosts
     packages (information only);
  2. build the hand-written kernels (csrc/fused_block.cu,
     csrc/fused_block_q.cu and csrc/attention.cu, one nvcc each, started
     together, sm_90a); count instructions in each library's SASS
     (cuobjdump) and fail if a design's own is 0, so a build that fell back
     to mma.sync or to the CUDA cores cannot pass unseen: HGMMA (bf16 wgmma)
     and UTMALDG (TMA load) in the bf16 library, IGMMA (s8 wgmma), UTMALDG
     and HGMMA (K3's wgmma core) in the int8 library, HGMMA (K5's bf16 short
     route) and the TF32 HMMA forms (its 3xTF32 float32 short route) in the
     attention library; the int8 library must hold no mma.sync (HMMA.,
     IMMA.) in any kernel, and each of the eight instantiations of KB (a)
     1's int8 attention core (attention_qq_kernel at its four key buckets,
     attention_qq_tiled_kernel at its four output widths) must hold s8
     wgmma (IGMMA) and TMA loads (UTMALDG);
     and per kernel, each of the eight heads-first instantiations of K5's
     long route (attention_long_kernel at bf16 and f32, head dims 64, 128
     and 192; attention_wide_kernel, the wide-head mode past them, at bf16
     and f32) and, in the bf16 and int8 libraries, the three packed ones K1
     and K3 run past 320 keys or past head dim 128 must hold its own forms,
     bf16 wgmma (HGMMA ... BF16) or tf32 wgmma (HGMMA ... TF32) and TMA
     loads (UTMALDG), and no mma.sync (HMMA.);
  3. kernel phase: each bf16 kernel against its plain PyTorch twin on the card,
     bf16, at B=8 for the image (S=197 D=768 H=12) and text (S=77 D=512 H=8,
     causal) shapes, at every key bucket of the wgmma attention core (S = 1,
     7, 257, 320, causal and not, B=2 D=512 H=8), at a ragged M (B=3 S=77:
     231 rows, not a multiple of the GEMM's 128-row tile) for both blocks and
     both activations, at SLIP-ViT-L/16's image shapes (B=8, S=197 D=1024
     H=16, F=4096 with the erf-gelu MLP), at RN50x4's text shapes (B=8,
     S=77 D=640 H=10, causal, F=2560; phase 18's tower), at the main path's
     B=256 image shapes of ViT-B/16 and of SLIP-L (phase 17) and at the bf16
     text tower's B=319 shapes (D=512, and D=640 for RN50x4); tolerance: max |kernel - twin| <= one bf16
     ulp of the twin's largest magnitude (SLIP-L's inputs come from a
     generator of their own, as do RN50x4's), and past the wgmma core's 320
     keys, on its long route (csrc/attention_long.cuh), at S = 321, 383,
     384, 385, 400 and 785 (and 320, still short), B=8 D=768 H=12, causal
     and not, x and x/16, the core-route counters showing one launch on
     the route fused_block.core_route names; K1 at B=32 S=785 (the
     Frozen-in-Time joint tower's measurement shape) timed, its core split
     out and held against the core's own bound.  At B=8 and at the ragged M each
     block also runs on a residual stream scaled by 1/16, where the output is
     mostly the block's own contribution, so the bar is tight against the
     attention / MLP math and not only against the residual.  At B=256 (both
     image towers) the two blocks are split by sub-kernel with torch.profiler (LN, QKV GEMM,
     core, out GEMM; LN, up GEMM, down GEMM), each GEMM with its TFLOP/s and
     share of the bf16 peak;
  4. main path: first native.available() for the port's native ingest and,
     when it is false, its build error; the run fails unless the only cause
     is a machine without the codec headers (jpeglib.h, png.h), and every
     wall time that reads image files names the decode path it took, so none
     silently comes from the Python path; then a ViT-B/16 DebiasCLIP (2
     prepended prompt tokens, random
     init from seed 0, full width and depth) through HostLoader (batch 256,
     patch-contiguous staging), get_labels_img_embeddings(dtype="bfloat16"),
     get_prompt_embeddings (the 319 generated prompts, stdlib byte
     tokenizer) and eval_ranking, on 1,024 seeded 224x224 uint8 images with
     balanced binary labels; the launch counters must show 12 x 4 launches
     of each kernel; metrics (whole ranking, and the top 10%, where MaxSkew
     is not trivially 0) finite and equal to the numpy oracle; bf16 image
     embeddings against the float32 plain path (cosine);
  5. the bf16 text tower once (causal attention kernel), cosine against the
     float32 text tower;
  6. int8 kernel phase: attention_block_q and mlp_block_q against their twins
     (weights from ops/quant.quantize_weight) at the same shapes, plus an
     act_kind="gelu" MLP, and SLIP-L's blocks (B=8, x and x/16, D=1024 H=16,
     the gelu MLP at F=4096, the widest hidden row the quantize pass holds
     in registers), and RN50x4's text blocks (B=8, x and x/16, D=640 H=10,
     causal, F=2560; and B=319), and K3 at S = 320-785 as K1 in phase 3
     (long route and counters) and K3 and K4 (gelu, F=3072) at B=32 S=785
     timed (the kernels line's FiT rows, launches: phase 19), K3's core
     split out; on K3's long route the bars are its attention rows within
     1 bf16 ulp of the twin's core and its output within 1 bf16 ulp of the
     twin's out-projection of the kernel's own codes, beside the code bars
     below (an int8 code the code bar admits moves an output by a code step
     through wo, past 1 ulp of the twin's output at times: PERF.md section
     6, PR 13); everywhere else the same 1-ulp bar on the output, and on the int8
     codes of the quantized rows (LN output, attention output, MLP hidden):
     the twin's quantizer applied to the kernel's own rows gives the kernel's
     codes and scales exactly, and the codes differ from the twin's in at
     most 1e-3 of all (by at most 1 in the LN and hidden rows, 2 in the
     attention rows); attention_block_q at every key bucket of the wgmma
     core (S = 1, 7, 200, 201, 256, 257, 320, causal and not, B=2 D=512
     H=8); a ragged M (B=3 S=77: 231 rows, x and x/16) for both blocks,
     causal and not, both activations; at B=256 (ViT-B/16 and SLIP-L) both
     blocks are split by sub-kernel with torch.profiler (LN, quantize x and attn, QKV GEMM,
     core, out GEMM; LN, quantize x, up GEMM, quantize h, down GEMM), each
     GEMM with its TOP/s and share of the int8 peak;
  7. the int8 main path: the same model and images through
     get_labels_img_embeddings(dtype="int8") (QuantizedCLIP, P8 staging, the
     int8 kernels with bf16 activations between them): 12 x 4 launches of
     each int8 kernel and none of the bf16 ones, metrics equal to the numpy
     oracle, int8 image embeddings against the float32 plain path (cosine);
  8. the int8 text tower ("int8-text"): 12 causal int8 launches, cosine
     against the float32 text tower;
  9. K5 phase: attention_pallas (csrc/attention.cu) against its twin
     attention_kernel_math, TF32 off, float32 (3xTF32 on the tensor cores)
     and bfloat16 (the wgmma core on the short route; the two-pass wgmma +
     TMA kernel on the long one), at the image shapes B=8 and B=64 (H=12,
     S=197) with a zero and a random additive mask, the text shapes B=319
     (the sensitive prompts) and B=64 (a caption batch), H=8, S=77, with
     CLIP's causal mask, and the long route at B=8 H=12 S=785 (the
     Frozen-in-Time joint tower's token count) with a zero and a random
     mask and at B=32 (its measurement batch) with a zero mask, all timed
     beside F.scaled_dot_product_attention with the same additive mask at
     the same shapes and dtype (the yardstick; the port never calls it);
     then, checked only, B=2 H=8 at S = 1, 7, 32, 33, 80, 81, 200, 201, 256,
     257 and 320 (both sides of every key bucket) with the zero and the
     causal mask, a ragged B*H (B=3 H=5, S=197 and S=785, random mask), the
     long route at S = 321, 383, 384, 385, 400, 785, 1025 and 2048 (a ragged
     last key tile, both sides of the 128-query block, 16 and 32 key tiles)
     with the zero, random and causal masks and at head dims 32, 80, 128 and
     192 (S = 77 and 197; 192 also at S = 785), and at bfloat16 with every
     score shifted by 1e6; each call launches once, on
     the route ``_plan`` gives its shape; bars 2e-5 of the twin's largest
     magnitude at float32, one bf16 ulp at bfloat16; then the long route on
     a Frozen-in-Time joint tower's path: 12 layers of the public
     attention(use_pallas=True) at B=8 H=12 S=785, float32 forward and
     backward and bfloat16 forward, with the counters set to 0 before each
     run: 12 long-route launches and no short one, finite values;
 10. training on the K5 path: a copy of the phase-4 model in
     AdversarialTrainer.create(use_pallas=True), float32, batch 64, the 319
     prompts as the sensitive set, 64 caption tokens; 3 steps; the K5 launch
     count must be 60 per step (two image passes of 12 layers, the 319-prompt
     text tower for the adversary's scores and again with the 64 captions in
     the prompt step, 12 layers each; the backward recomputes through the
     twin and launches nothing), no K1-K4 launch, finite losses, moved
     tokens; the same three steps with use_pallas=False (no kernel), whose
     first token gradient and update must each have a cosine of at least
     0.9999 with the K5 path's;
 11. training on the bf16 fused path (train_dtype and embed_dtype
     "bfloat16"): per step K1 non-causal and K2 24 times in the two embed
     passes, causal K1 36 times in the text passes (K2 36 more); the token
     gradient of the bf16 text tower reaches the prompt array (cosine with
     the float32 gradient >= 0.99), and so does the first prompt step's
     (cosine >= 0.99 with the float32 step's); the first update, Adam's
     ~lr x sign(g), flips the sign of at most 5% of the elements of the
     float32 step's update (its cosine is reported);
 12. run_training at full width on a seeded synthetic FairFace layout in a
     temporary directory (256 train and 128 val images at 224 px, batch 64,
     one epoch of 4 steps, one eval at step 4 and the final one),
     use_pallas=True, once through the frozen-embedding cache and once
     decoding every batch: K5 launch counts as the two paths imply, the
     checkpoint and the .pt export (a bare float32 tensor) written, and the
     two runs end with identical losses and tokens;
 13. timings: kernels vs twins and their bounds, image-tower img/s with the
     bf16 kernels, the int8 kernels, the plain int8 path (torch._int_mm
     products), the plain bf16 path and the float32 path, and ms per
     training step on the float32 plain, K5 and bf16-kernel paths;
 14. the embedding cache on the main path: measure_bias(dtype="bfloat16",
     cache_embeddings=...) of the phase-4 model on a written FairFace val
     layout (512 images at 224 px, two batches): the image tower's
     fingerprint equal on the card and on a CPU copy; an uncached MaxSkew
     call at top-n 0.1; a miss (NDKL at top-n 1.0: K1 and K2 12 launches
     per batch, nothing else); an int8 miss in its own file (K3 and K4 12
     per batch); the val images deleted, then a bf16 hit (MaxSkew at 0.1:
     no launch, the labels and embeddings it ranks bit-identical to those
     the miss ranked and wrote, metrics equal to the uncached call's within
     1e-5) and an int8 hit (no launch); an int8 call on the bf16 file
     raises; the same model with other debias tokens hits; a copy with one
     vision weight one float32 ulp away raises the key mismatch; the
     fingerprint's, the miss's, the hit's and the uncached call's wall times;
 15. the adversary ablation (train/efficacy.py) at the JAX module's
     defaults (2,048 + 512 images at 32 px, 2,500 pretraining steps, 3
     epochs of batch 64, eval every 8, top-k 50): seed 0, or, if its world
     fails the harness's preconditions, seed 1, then seed 2; fails if none
     of them is valid; each stage's wall time; both arms' before, after,
     reduction and curve; the arms' before identical, every value finite,
     the .pt exports loading, at least 3 curve points per arm; no kernel
     launches (a float32, width-64 tower with use_pallas=False).  Then the
     card against the CPU from one start: for every seed that ran, the
     pretraining's step-0 loss and gradients within 1e-5 (of each
     tensor's largest magnitude, at least 1), after 3 Adam steps the loss
     within 1e-4 and the update's cosine >= 0.9999, 20 steps reported;
     for the valid seed, both arms again on the CPU from the card's
     pretrained tower, every eval, before and after within 1e-3
     (the probe 1e-2).  Whether the adversarial arm's NDKL drop beats the
     control's, on the card and in the CPU replay, and JAX's stricter
     bars are printed, not gated: the outcome is the seed's and the float
     configuration's (tests/test_efficacy.py's docstring), not the port's.
 16. serving (serve/engine.py, the micro-batcher and the HTTP server) on the
     phase-4 model: an InferenceEngine (bfloat16, max_batch 64, the byte
     tokenizer) warmed up bucket by bucket (1-64, both towers, each timed),
     a ServeApp (max_wait_ms 5) and make_server on 127.0.0.1, an ephemeral
     port, served from a thread; then over HTTP: /healthz (backend cuda and
     the card's name), /v1/embed/image with 4 base64 PNGs, /v1/embed/image-raw
     with 100 u8 frames (buckets 64 and 64) and 8 JPEG records (the decode
     path printed), /v1/embed/text with the 319 prompts, /v1/score (1 image,
     8 texts; probs sum to 1 within 1e-5), 32 concurrent single-image
     clients (the batcher must form fewer dispatches than requests), an
     undecodable image (400) and the next request (200), and one request
     per bucket 1, 2, 4, ..., 64 for both towers; any other status fails.
     Every dispatch the engine made for those requests is held to a direct
     encode_image / encode_text call on the same staged bucket (one bf16
     ulp of the row's largest magnitude; bit equality expected, the largest
     difference printed), every row a client received must be the engine's
     row bit for bit, and every served row has a cosine >= COS_MIN with the
     float32 plain path; the launch counters equal 12 x the image
     dispatches for K1 and 12 x (image + text) for K2, 12 x the text
     dispatches for causal K1, and nothing else.  Printed, not gated: p50
     and p99 latency of 50 sequential single-image and single-prompt
     requests, the end-to-end img/s of 256-frame u8 requests beside phase
     13's tower img/s, the 32 clients' coalesced img/s, and per dispatch
     the host staging + launch time against the fetch time.  Then an int8
     engine (its own server): 100 u8 frames and 64 prompts, the same row
     check and cosine bar, K3 and K4 12 per image dispatch and none of the
     image tower's K1 / K2, causal K1 and K2 12 per text dispatch.
 17. SLIP-ViT-L/16 at full width and depth (D=1024, 24 layers, 16 heads,
     F=4096; DebiasCLIP with 2 prepended tokens, random init from seed 0):
     (a) phase 4's measurement pipeline on the first 512 of its images (P8
     staging, the 319 prompts) at bfloat16 and at int8, with the counters
     set to 0 before each: K1 and K2 24 x 2 launches each and nothing else
     (bf16), K3 and K4 24 x 2 each and nothing else (int8); metrics equal to the
     numpy oracle; image embeddings of the first 256 against the float32
     plain tower: cosine >= COS_MIN at bf16; at int8 the kernel path's mean
     cosine error at most INT8_ERR_RATIO times that of the plain int8 route
     on the same batch (the rung's own arithmetic stays below COS_MIN on
     this random tower); wall time, tower img/s and the card printed;
     (b) the same weights written as an OpenAI-named .pt and a SLIP-named
     .pt ({"state_dict": ...}, module. prefixes, visual.blocks.*, an
     SSL-head tensor), and phase 4's ViT-B/16 as a HuggingFace-named .pt
     (names built here by the inverse of hf_to_openai_state_dict, no
     transformers), each loaded through model_loader(weights=...): image
     (bf16 kernels) and text (float32) embeddings bit-equal to the
     original's; (c) zero-shot over 8 classes x 16 seeded 224 px PNGs with
     the 80 ImageNet templates (640 prompts) at float32 and bfloat16: top-1
     / top-5 / n equal to a numpy recount from the embeddings the tower
     returned (a forward hook) and the classifier, 24 K1 and K2 launches at
     bfloat16 and none at float32; the card's float32 classifier within
     1e-5 of the CPU port's for 2 of the classes; and the CLI once
     (python -m debias_vision_lang_torch zero-shot --random-weights --dtype
     bfloat16 --model facebookresearch/SLIP/ViT-L/16, a toy BPE vocabulary):
     exit 0 and a JSON with top1, top5 and n = 128.
 18. the ModifiedResNet family at full width and depth: RN50 (224 px, stages
     3-4-6-3, stem 64, 32 pool heads; text 512 wide, 8 heads) and RN50x4
     (288 px, 4-6-10-6, stem 80, 40 pool heads; text 640 wide, 10 heads),
     DebiasCLIPs with 2 prompt tokens, random init from seed 0, every
     BatchNorm redrawn (scale and bias from a seeded generator, scale in
     [0.5, 1], a bottleneck's bn3 in [0.1, 0.3]: the init's zero bn3
     scales would leave every residual branch dead; running mean and var
     the statistics of each BatchNorm's input over 32 other seeded scenes),
     cuDNN's TF32 flag at PyTorch's default (on); per tower, 256 seeded uint8 scenes at its size (a bilinear
     4 x 4 colour grid plus noise: iid noise images all embed alike through
     a pooled CNN, and their scores tie within float32 rounding) through
     HostLoader (NHWC, no patch staging), get_labels_img_embeddings,
     get_prompt_embeddings (319 prompts, byte tokenizer) and eval_ranking at
     float32, bfloat16, int8 and int8-text: metrics equal to the numpy
     oracle; image rows against float32 at cosine >= COS_MIN (bf16) and >=
     RN_INT8_COS (int8 rungs); no kernel launched by the image tower; the
     prompts run no kernel but under int8-text (12 causal K3 + 12 K4), and
     the bf16 text tower 12 causal K1 + 12 K2 (cosine >= COS_MIN against
     float32); img/s at B=256 per rung, the int8 tower split (quantize,
     im2col, _int_mm, the rest; torch.profiler ranges); the TF32 witness
     (4 images, the card's float32 tower within RN_TF32_TOL of the CPU
     port's largest magnitude; the same with TF32 forced on printed beside
     it); for RN50 an OpenAI-named .pt loaded back through model_loader
     (image rows at bf16 and text rows at float32 bit-equal) and the bf16
     serving engine (buckets 1 and 64 bit-equal to the direct call on the
     same staged batch, no launch).
 19. the Frozen-in-Time video family at full width and depth
     (m-bain/frozen-in-time/base: ViT-B/16 over 4 frames, 768 wide, 12
     layers and heads, embed 256, ImageNet statistics; CLIP's 512-wide
     text tower), a DebiasCLIP with 2 prompt tokens, random init from seed
     0, the temporal embedding and every temporal out-projection redrawn
     from a seeded generator (the init zeroes them: the divided tower's
     temporal attention would be the identity); 64 written videos (32
     frame directories of 6 PNGs named frame_2 .. frame_12, so only a
     natural sort orders them, and 32 GIFs of 6 palette frames, 224 px;
     a labels.csv in FairFace's vocabulary), each subsampled to 4 frames;
     for each formulation, joint (S = 785) and divided: measure_bias(
     dataset="video", batch 32, the 319 prompts, byte tokenizer) at
     float32, bfloat16, int8 and int8-text with the counters set to 0 before
     each: metrics equal to the ranking of the rows it cached and to the
     numpy oracle within 1e-5; rows against float32 at cosine >= 0.999
     (bf16) and 0.99 (int8 rungs); launches: none at float32 and bf16 (the
     video towers run plain, as in JAX; the bf16 text tower, run beside
     it, 12 causal K1 + 12 K2), 24 K3 + 24 K4 at int8 (joint: every K3 on
     the long core route; divided: on the short one), int8-text 12 causal
     K3 + 12 K4 more; videos/s and frames/s at B=32 per rung (CUDA events)
     and each measurement's wall; use_pallas=True on 8 videos at float32
     and bf16 through encode_image: 12 long-route K5 launches (joint), 24
     short-route (divided), held to use_pallas=False (2e-5 of the largest
     magnitude; cosine >= 0.9999); the float32 witness (2 videos, card vs
     the CPU port, 1e-4 of the largest magnitude); an m-bain-named .pt
     ({"state_dict": {"module.video_model.*", "module.vid_proj.0.*"}})
     loaded through model_loader bit-equal, "divided" as trained and
     "joint" once timeattn.proj is zeroed; the joint tower's cache file
     refused for the divided tower built from the same tensors.
 20. distribution (parallel/mesh.py, metrics/distributed.py) on the phase-4
     model: measure_bias on 256 written FairFace images with mesh="auto"
     (one slot on the one card) bit-equal to the unsharded call at bf16 and
     int8, 12 launches per kernel; a virtual 4-way mesh
     create_mesh(devices=[cuda:0] * 4) embedding a ragged batch of 254
     images (padded to 256, four shards of 64) at bf16 and int8: 4 x 12
     launches per kernel, rows bit-equal to the unsharded call (else within
     one bf16 ulp of the largest magnitude, the reason printed), and
     sharded_eval_ranking on them equal to the numpy oracle within 1e-5,
     also with exact planted boundary ties (scores made integers, then 20
     distinct rows, or every row equal but one), a per-shard budget
     escalated at least once; the mesh's overhead on the bf16 tower at
     B=256 against the unsharded call (CUDA events, in turns); zero-shot
     (4 classes x 16 images, batches of 30) under the mesh: predictions and
     top-1 / top-5 equal to the unsharded call's, 4 x 12 launches a batch;
     the serving engine at data = 4 (buckets 4-64, both towers): every
     dispatch bit-equal to the mesh's direct call on the same staged
     bucket, the difference from the unsharded call printed in bf16 ulp;
     the trainer under the mesh (3 steps, batch 64): float32 frozen and
     with one image layer trained (K5, use_pallas=True), and the bf16
     kernels' frozen step, each against the unsharded trainer: first token
     gradient and first update cosine >= 0.9999 at float32 (at bf16 the
     bars of phase 11: gradient cosine >= 0.99, <= 5% of the first
     update's signs flipped), every token within Adam's bound 2 x lr x
     steps, launches once per shard in the image passes;
     then a two-rank world on the card (two processes, both on cuda:0,
     gloo, a file:// rendezvous; ``python3 chip_smoke.py --dist-rank R
     RENDEZVOUS FAIRFACE OUT`` is one rank): measure_bias(mesh="auto",
     sharded_metrics=True) at bf16 on both ranks within 1e-5 of one
     process, equal on the two, 12 launches per kernel per rank, the
     collective path printed; and on each rank 2 bf16 steps of a trainer
     whose top image layer trains (K1 / K2 forward, twin backward, the
     image rows gathered with their gradient, the layer's gradient summed
     across the ranks): both ranks' trainer state (a sha256 over every
     trained tensor and its Adam moments) equal after every step, the first
     token gradient and update held to one process by phase 11's bf16
     bars, each rank's launches the one process's; each sub-phase's wall
     time.
 21. the "auto" rung and the registry archs no phase ran before: K1-K4
     against their twins (and timed) at ViT-B/32's B=256 S=50 D=768, at
     ViT-L/14's B=256 S=257 D=1024 H=16 F=4096 and at its text tower's
     B=319 S=77 D=768 causal; ViT-B/32, ViT-L/14, SLIP-ViT-B/16 and RN101
     (model_loader, seed 0, full width and depth; RN101's BatchNorms
     redrawn as phase 18's) at float32, bfloat16, int8 and int8-text: the
     image tower's img/s at B=256 (CUDA events), its launches per forward
     (12 or 24 per kernel on a ViT, none on the ResNet), its rows against
     float32 (bf16 >= 0.999; int8 >= 0.999 on ViT-B/32, phase 17's
     relative bar on ViT-L/14 and SLIP-B/16, >= 0.99 on RN101), ViT-L/14's
     text tower at bf16 and int8-text; measure_bias(dtype="auto") on 256
     written FairFace images (the phase-4 ViT-B/16, SLIP-B/16, RN50) and
     32 written videos (the Frozen-in-Time joint tower): metrics, cached
     embeddings and cache key bit-equal to the explicit rung's call, the
     rung's launches, and an "auto" call hitting that call's cache file;
     the serving engine and zero-shot at "auto" bit-equal to "int8"; the
     CLI's measure-bias --dtype auto exiting 0; a table of arch x rung
     img/s beside the rung "auto" picks (printed, not gated).
 22. tensor parallel (``parallel/mesh.shard_clip_params`` /
     ``shard_quantized_clip``, ``parallel/tensor.py``) on virtual (data,
     model) meshes of the one card (the split's overhead, not a speed-up):
     the split entries against their twins with the residual at x and
     x/16 -- ``attention_block_heads`` and KB (a) 6's
     ``attention_block_hgrid`` at B=256 S=197 D=768 H=12 on head groups of
     12, 6 and 3, the causal text shape B=319 S=77 D=512 at 4 and 2, the
     long core at B=8 S=785 on 6, ``mlp_block_cols`` at F/m = 1536 and 768,
     each within 1 bf16 ulp of its twin's largest magnitude, ``tp_reduce``
     bit-equal to its twin; the int8 entries' codes and int32 partials
     equal to the twin's, and the reduced int8 halves bit-equal to K3 / K4;
     KB (a) 6 timed beside K1 at B=256 and on a path: the phase-4 image
     tower's 12 attention halves through it (rows vs the K1 tower >=
     0.999); the (1, 8) split (ViT-B/16's 12 heads in slots of 2 and
     1, 384 hidden columns a slot) timed at B=256, and two towers of random
     blocks off the registry splits (TP_WIDE: 2 heads over 4 slots, two of
     them empty; ViT-H/14's widths, 16 heads of 80, over 2) against K1-K4;
     the float32 forward of the phase-4 model under (1, 2) and (2,
     2) within 1e-4 of unsharded (JAX's bar); under (1, 2), (2, 2), (1, 4)
     and (1, 8) every bf16 image and text block within 1 bf16 ulp of K1 + K2 on
     the same input, the towers' rows cosine >= 0.9999 against unsharded
     bf16 (beside the drift of the same tower on the twins from the
     kernels) and >= 0.999 against float32, the int8 towers (image, text under
     int8-text) bit-equal to the unsharded int8 towers (or the difference
     printed and cosine >= 0.99999 held), launches 12 m per head / column
     entry and 24 reduces per data shard with no K1-K4; the Frozen-in-Time
     joint int8 tower at B=8 (S = 785, the long core) under (1, 2)
     likewise; one float32 adversary + prompt step (JAX's dryrun) on the
     DebiasCLIP placed under (2, 2): the token gradient within 1e-5 of the
     unsharded step's largest magnitude, losses within 1e-6; each TP
     tower's ms beside the unsharded one's.  The slot entries split
     (``tp_slot_split``, int8 and bf16: each kernel's device time, host time,
     event wall) and held to the designs before them (every output
     bit-identical to ``tp_slot_parent.json`` / ``tp_slot_bf16_parent.json``,
     no parent kernel's SASS changed but those the designs replaced); the
     bf16 slots on their routes (``fused_block.slot_route``: the out / down
     product on the row-strip kernel or the GEMM) bit-equal to the GEMM
     route at D = 768, 512 causal, 200, 203 and S = 785, and the towers'
     calls counted per route; a whole NaN
     row of x through K3, K4, the int8 MLP slots, ``rows_q_partial``,
     ``tp_reduce_q`` and KB (a) 1's core: NaN amaxes and scales, codes 0,
     NaN output rows, every other row bit-equal to the run without it.
 23. KB (a) 1-4, the int8 kernel experiments of ``benchmarks/``
     (``fused_block_q.attention_block_qq`` with its int8 core
     ``attention_qq_core`` in csrc/attention_qq.cuh, ``mlp_block_q_bf16h``,
     ``mlp_block_q_var`` at both gelus, ``attention_block_q_var``): each
     against its twin at B=8 S=197 D=768 H=12 with the residual at x and
     x/16 -- the output within 1 bf16 ulp of the twin's largest magnitude,
     every int8 code the twin's quantizer (``quant_rows`` or
     ``quant_rows_recip``) of the kernel's own rows, the codes off the
     twin's under phase 6's bars (the qq block's attention codes printed:
     the core's flipped p codes move them); the int8 core on the kernel's
     own f32 qkv and at both sides of its key buckets (S = 50-256): its p
     codes the quantization of its own p, its output the twin's P V on
     those codes bit for bit and within 1 ulp of the twin's, any element
     past it on a row with a flipped p code; the variant's core on the long
     route (S = 400); each timed at B=256 beside K3 / K4 with its bound; the
     scripts' towers (12 attention or MLP halves of the phase-4 model's
     quantized resblocks at B=256): launches 12 per entry, cosine against
     the K3 / K4 tower printed, not gated, and ms beside it.  KB (a) 3
     (LayerNorm and the reciprocal quantize in one pass, then K4's
     up GEMM, quantize pass and down GEMM: 4 launches a call by the
     profiler, each tower call on the "ln" route) held to the design before
     it (benchmarks_torch/kb_var_parent.json: every output, code, scale and
     row of benchmarks_torch/kb_var_split.py's B <= 32 cases and its two
     12-layer towers bit for bit; the launches before it the same bits;
     the int8 library's kernels the same SASS but the new ones, the
     divide-after core's HGMMA and UTMALDG), and a kernels-line row at the
     text tower's D = 512.
 24. K4's F-split (``fused_block_q.mlp_block_q(fb=)``, KB (a) 7's
     ``make_fsplit``), KB (a) 5 (``fused_block.attention_block_opt``), the
     one-call int8 layer of q_layer_fused.py (``fused_layer_q``) and
     q_ilp4.py's post-P V division (``attention_block_q_postdiv``): each
     against its twin at B=8 S=197 D=768 H=12 with the residual at x and
     x/16 (the split at fb = 1536 and 768 with both activations; the
     codes as phase 23 holds them, chunk by chunk for the split; the
     layer's f32 y bit-equal to x + (deq + bo) of its own codes), KB (a) 5
     on its long core (S = 400), the split at the int8 joint FiT shape B=32
     S=785 at fb = 1024, and fb = 192 (off the s8 GEMM's K step: each chunk
     padded to 256 lanes) against its twin; each timed at B=256 beside K1, K4 or
     K3 + K4 with its bound; the scripts' 12-layer towers on the phase-4
     model's resblocks (KB (a) 5 vs K1 at bf16, the split vs K4, the layer
     vs K3 then K4, the post-P V division vs K3, the FiT-shape split vs
     K4): launches 12 per entry, cosine printed, not gated, ms beside the
     baseline's.  The layer (its QKV product on the persistent TMA-store
     GEMM gemm_s8_tma_kernel, its down product on the epilogue-warpgroup
     GEMM gemm_s8_epi_kernel, LayerNorm and the quantize pass in one at
     both norms: 9 launches) held to the design before it
     (benchmarks_torch/layer_parent.json: every output, code and scale of
     benchmarks_torch/layer_split.py's cases and its 12-layer tower bit for
     bit, the int8 library's kernels the same SASS but the new two), its
     products on the s8 GEMM route the same outputs bit for bit; its
     LayerNorm codes held to K3's / K4's LayerNorm rows of the same inputs.
     q_ilp4's attention (LayerNorm and quantize in one pass,
     the QKV product on the TMA-store GEMM, the core's divide-after
     instantiation: 5 launches a call, each tower call on the "tma" route)
     held to kb_var_parent.json likewise, and a kernels-line row at the
     FiT shape B=32 S=785 (its core on the long route).
 25. benchmarks/q_attribution.py's blocks (KB (c)):
     ``fused_block_q.mlp_block_q_attr`` / ``attention_block_q_attr`` at
     modes "mxu" (the products only, XLA's saturating int8 casts, the wgmma
     core with its softmax off) and "vpu" (the elementwise chain only, the
     products broadcasts): the SASS of their instantiations (IGMMA and
     UTMALDG in the four s8 GEMMs they run, HGMMA in each softmax-off core,
     no mma.sync, the stub kernels present); each against its twin at B=8
     (x and x/16) and B=256 and the "mxu" attention at S=400 on the long
     core (its codes the twin's conversion of its own rows, off the twin's
     under phase 6's bars; the output bit-equal to the twin's last step on
     its own codes and within 1 bf16 ulp of the twin where every code is
     the twin's); each timed at B=256 beside K3 / K4 with its bound and
     split by sub-kernel; the script's six 12-layer towers ("full" = K3 /
     K4) on the phase-4 model's resblocks at its B=512: launches 12 per
     tower, ms, full / (mxu + vpu) and full / max(mxu, vpu) printed.
 26. the port's bench (``benchmarks_torch/bench.py``, the root bench.py's
     counterpart) on its own ViT-B/16 (``init_clip_params`` at seed 0): the
     root bench.py's six configurations through ``bench.run`` (a int8 with
     the P8 stem, the headline; b int8 with the f32 stem; c bf16 with the
     P8 stem; d c with BENCH_PALLAS; e bf16 with the f32 stem; f float32,
     with and without BENCH_PALLAS, at 3 steps): each record's four keys,
     metric and unit; launches 12 x (2 + steps) per kernel the
     configuration runs (K3 + K4; K1 + K2; K5 on its short route) and none
     of another (f: none); each configuration's rows on 64 uint8 images
     against f's at cosine >= 0.999; img/s per configuration and for a at
     B = 256, 512, 1024 (host clock); then ``python -m
     debias_vision_lang_torch bench`` in a subprocess: exit 0, one stdout
     line with the record.
 27. K1-K4 at shapes the JAX kernels take off the registry archs' widths
     (``shape_phase``; on ``ops/fused_block.py::attn_plan`` / ``mlp_plan``'s
     padded operand layouts): SigLIP-So400m's widths (D=1152, 16 heads of
     72, F=4304, gelu) at B=64 S=257 and B=8 S=729 (the long core),
     ViT-H/14's (D=1280, heads of 80, F=5120) at B=64 S=257, bigG/14's
     (D=1664, heads of 104, F=8192) at B=32 S=257, D=200 H=2 F=808 at B=8
     S=77 causal and not, one head of 256 and one of 800 (the long core; K1,
     K2 and K4 at 800, see SHAPE_CASES), and
     K4 at fb = F / 4 = 1076: each against its twin at x and x/16 (1 bf16 ulp;
     the int8 codes under phase 6's bars, K3 on its long core as phase 6
     holds it), each launch counted and its core route named, timed against
     the bound of the true (unpadded) work; the padding's cost (K1 / K3 at
     B=64 S=257 D=1280, 16 heads of 80 against 20 heads of 64, in turns);
     then a CLIP from a hand-built CLIPConfig at ViT-H/14's image widths (32
     layers, patch 14, 224 px, random weights from seed 0) at B=32: bf16 (32
     K1 + 32 K2 on the short core) against float32 at cosine >= COS_MIN, int8
     (32 K3 + 32 K4) held to the plain int8 route (phase 17's bar), img/s
     of both and of the plain routes; K1's core alone at the heads of 256
     and 800 (the wide-head mode on the packed source: its time from the
     block's split, its bound, SDPA on the same function).  Beside them
     (``wide_checks``): K5 at head dims 256 and 800 (the long route's
     wide-head mode), B=2 H=4 at S = 77 and 785 and B=8 H=12 (a Frozen-in-Time
     joint tower's) at S = 785, and at head dim 192 (the head resident, B=8
     H=12 S=785), float32 and bfloat16 at phase 9's bars, the wide mode's
     pre-pass and statistics launches counted exactly, each output's digest
     printed against the design the mode replaced (WIDE_K5_PARENT), the S =
     785 cases timed beside SDPA; KB (a) 1's int8 core and
     block on their tiled route (B=2: S = 257 and 785 at D = 768, head dim
     80 at D = 960; B=32 S=785 D=768, the int8 joint Frozen-in-Time
     attention, timed beside K3 on its long core) at phase 23's bars;
     every KB entry at D = 200 with 2 heads of
     100 and F = 800 (``kb_off_registry``) at its own phase's bars; each
     launch counted, each timed against its bound.
The kernels line comes after phase 27 (its SLIP-L rows take phase 17's
launch counts, its RN50x4 text rows phase 18's, its FiT rows phase 19's,
the rows of phase 21's shapes its sweep's, the split entries' rows phase
22's (1, 2) towers' and KB (a) 6's its tower's, KB (a) 1-4's phase 23's
towers', phase 24's and 25's rows their towers', phase 27's rows its
checks' launches, the ViT-H/14-width rows its tower's) and gives each kernel's launches, error, time, plain-twin time,
its bound (the larger of its operations over the H100 SXM's dense peak for
their type and its bytes, each input read once and each output written once,
over 3.35 TB/s; K5's float32 operations count three TF32 products each, as
its 3xTF32 design runs them) and the library call's time where one PyTorch
call computes the same function.  K1-K4 have a row at ViT-B/16's B=256
image shapes (launches: phases 4 and 7), one at SLIP-L's (launches:
phase 17) and one at RN50x4's text shapes, B=319 S=77 D=640 causal
(launches: phase 18); K3 and K4 one at the int8 joint Frozen-in-Time
tower's B=32 S=785 D=768 (launches: phase 19; K3 on its long core, whose
time alone is its "core_ms"); K1-K4 one at each of phase 21's three shapes
(launches: phase 21's towers); each row names its "case".  K5 has two rows on its short route:
float32 causal B=319 S=77 (the text shape) and float32 B=64 S=197 (the image
shape that holds most of its training launches); its long route two more,
float32 and bfloat16 at B=8 H=12 S=785 with a zero mask, whose launches are
those of the joint tower's path in phase 9.  The line
before the last is the card's ``nvidia-smi``
name and power limit; the last line is {"ok": true, "device": {...}}.
"""

import copy
import csv
import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

BATCH, N_IMAGES, LAYERS = 256, 1024, 12
COS_MIN = 0.999  # per-row cosine, bf16 / int8 kernel path vs the float32 plain path
INT8_ERR_RATIO = 1.1  # SLIP-L int8: mean cosine error, kernel path / plain int8 route
METRIC_ATOL = 1e-5  # device ranking engine vs the numpy oracle
CODE_SHARE_MAX = 1e-3  # int8 codes of a block's quantized rows that differ from the twin's
# a bf16 flip of a row's largest attention output (the attention core sums
# in another order than the twin) moves that row's scale, and with it the
# codes of the row by up to one more step than the element's own flip
CODE_DIFF_MAX = {"xq": 1, "hq": 1, "aq": 2}
TOPNS = (1.0, 0.1)  # whole ranking (measure_bias's default) and the top 10%
TRAIN_BATCH, TRAIN_STEPS = 64, 3
UPDATE_COS_K5 = 0.9999  # first token gradient and update, K5 vs the plain float32 path
UPDATE_COS_BF16 = 0.99  # token gradients, bf16 vs float32
UPDATE_FLIP_MAX_BF16 = 0.05  # first token update, bf16 vs float32: share of sign flips
# NVIDIA H100 SXM, dense: tensor-core bf16, int8 and TF32, float32 outside the
# tensor cores, and HBM3 bandwidth (the bounds in the kernels line)
PEAK = {"bf16": 989e12, "int8": 1979e12, "tf32": 494.7e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# the image towers whose blocks phases 3 and 6 time at B=256: (model, D, heads,
# MLP activation, weight seed); SLIP-L is phase 17's tower
IMAGE_TOWERS = (("ViT-B/16", 768, 12, "quick_gelu", 7), ("SLIP-ViT-L/16", 1024, 16, "gelu", 9))
SLIP_ARCH, SLIP_LAYERS = "facebookresearch/SLIP/ViT-L/16", 24
# images phase 17 measures at each rung: the first two of phase 4's batches
# (the numpy metrics oracle's NDKL at top-n 1.0 takes ~10 s a rung at 1,024)
SLIP_IMAGES = 2 * BATCH
RN_TEXT = (640, 10)  # RN50x4's text tower: width and heads (phases 3, 6 and 18)
# K1 / K3 past the register core's 320 keys (phases 3 and 6): a ragged last
# key tile, both sides of the long route's 128-query block, and the
# Frozen-in-Time joint tower's 1 + 4 x 196 tokens; S = 320 stays short
LONG_CORE_S = (320, 321, 383, 384, 385, 400, 785)
FIT_JOINT_S = 785


def core_work(b, h, s):
    """K1 / K3's attention core alone: Q K^T and P V (4 B H S^2 64 bf16
    operations, the minimum; the long route computes Q K^T twice) against
    qkv read and attn written once."""
    d = h * 64
    return {"bf16": 4 * b * h * s * s * 64}, b * s * 3 * d * 2 + b * s * d * 2


def routes_of(mod, s):
    """The core-route counts one launch of ``mod``'s attention block at
    ``s`` keys leaves."""
    return {r: int(r == mod.core_route(s)) for r in ("short", "long")}


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def bound(ops: dict, nbytes: float):
    """(ms, what bounds it): the larger of the operations over the peak for
    their type and the bytes over the memory rate."""
    t_ops = sum(n / PEAK[kind] for kind, n in ops.items())
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attention_block_work(b, s, d, causal=False, weights="bf16"):
    """Operations by type and bytes of one attention block: the QKV and out
    projections in the weights' type, the core (Q K^T and P V over the key
    pairs the mask keeps) in bf16; x and out bf16, each read / written once."""
    m = b * s
    pairs = s * (s + 1) / 2 if causal else s * s
    wb, extra = (1, (3 * d + d) * 4) if weights == "int8" else (2, 0)
    ops = {weights: 2 * m * d * 3 * d + 2 * m * d * d}
    ops["bf16"] = ops.get("bf16", 0) + 4 * b * pairs * d
    return ops, 2 * m * d * 2 + 4 * d * d * wb + 6 * d * 4 + extra


def mlp_block_work(b, s, d, f, weights="bf16"):
    m = b * s
    wb, extra = (1, (f + d) * 4) if weights == "int8" else (2, 0)
    return {weights: 4 * m * d * f}, 2 * m * d * 2 + 2 * d * f * wb + (3 * d + f) * 4 + extra


def attention_work(b, h, s, f32, cuda_cores=False, hd=64):
    """K5: softmax(q k^T / sqrt(hd) + mask) v over [B, H, S, hd] with an [S,
    S] f32 additive mask (every pair is computed: the mask is data), at the
    true head dim.  float32 runs 3xTF32: three TF32 products per f32 product
    on the tensor cores (``cuda_cores``: f32 FMAs on the CUDA cores, the
    bound of the design that ran them, for comparison)."""
    flops = 4 * b * h * s * s * hd
    ops = ({"f32": flops} if cuda_cores else {"tf32": 3 * flops}) if f32 else {"bf16": flops}
    return ops, 4 * b * h * s * hd * (4 if f32 else 2) + s * s * 4


def ulp_bf16(mag: float) -> float:
    return 2.0 ** (math.floor(math.log2(mag)) - 7)


def cuda_ms(fn, iters=10):
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


class SyntheticFaces:
    """In-memory dataset: seeded px x px x 3 uint8 images, balanced labels."""

    def __init__(self, n: int, seed: int = 0, px: int = 224):
        self.n, self.seed, self.px = n, seed, px
        self.iat_labels = np.arange(n) % 2

    def __len__(self):
        return self.n

    def load_image(self, i: int) -> np.ndarray:
        return np.random.default_rng(self.seed + i).integers(
            0, 256, (self.px, self.px, 3), dtype=np.uint8)


class SyntheticScenes(SyntheticFaces):
    """Seeded px x px x 3 uint8 scenes: a 4 x 4 grid of random colours,
    bilinearly upsampled, plus uniform noise of +-64.  iid noise images
    share their statistics, so a CNN that pools over space embeds them
    nearly alike, their scores for a prompt sit within float32 rounding of
    each other and a ranking check reads rounding; these scenes differ as
    photos do (``benchmarks_torch/resnet_image_spread.py``).  Each is made
    once and kept: every rung reads the same ones."""

    def __init__(self, n: int, seed: int = 0, px: int = 224):
        super().__init__(n, seed, px)
        self.made = {}

    def load_image(self, i: int) -> np.ndarray:
        if i not in self.made:
            self.made[i] = self.scene(i)
        return self.made[i]

    def scene(self, i: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + i)
        img = upsample_grid(rng.uniform(0, 255, (4, 4, 3)), self.px)
        img = img + rng.integers(-64, 65, (self.px, self.px, 3))
        return np.clip(img, 0, 255).astype(np.uint8)


def upsample_grid(grid, px):
    """A 4 x 4 x 3 colour grid bilinearly upsampled to px x px (float)."""
    t = np.clip((np.arange(px) + 0.5) * 4 / px - 0.5, 0, 3)
    i0 = np.floor(t).astype(int)
    i1, w = np.minimum(i0 + 1, 3), t - i0
    rows = grid[i0] * (1 - w)[:, None, None] + grid[i1] * w[:, None, None]
    return rows[:, i0] * (1 - w)[None, :, None] + rows[:, i1] * w[None, :, None]


def print_ptxas(lib: str, log: str) -> None:
    """One line per compiled kernel from nvcc's -Xptxas -v report."""
    name = spill = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?"
                      r"(gemm_s8_kernel|gemm_wgmma_kernel|attention_wgmma_kernel|"
                      r"layer_norm_kernel|quant_rows_kernel|quant_rows_wide_kernel|"
                      r"attention_f32_kernel|"
                      r"attention_long_kernel|attention_wide_kernel|split_tf32_kernel|"
                      r"attention_qq_kernel|attention_qq_tiled_kernel|qq_quant_qk_kernel|"
                      r"qq_quant_v_kernel|cast_s8_kernel|ln_quant_rows_kernel|row_amax_kernel|"
                      r"bcast_rows_kernel|attention_vpu_core_kernel|gemm_strip_f32_kernel)"
                      r"(I(?:Li\d+E|Lb[01]E|13__nv_bfloat16|f)+E)?", line)
        if m:
            # a GEMM's bool is its ragged N edge, the v quantizer's its staging,
            # another kernel's its source
            bools = ({"Lb1E": "ragged", "Lb0E": None} if m.group(1).startswith("gemm_")
                     else {"Lb1E": "staged", "Lb0E": "re-read"}
                     if m.group(1) == "qq_quant_v_kernel"
                     else {"Lb1E": "full", "Lb0E": "guarded"}
                     if m.group(1) == "ln_quant_rows_kernel"
                     else {"Lb1E": "packed", "Lb0E": "heads"})
            args = [{"13__nv_bfloat16": "bf16", "f": "f32", **bools}.get(a, a.strip("LiE"))
                    for a in re.findall(r"Li\d+E|Lb[01]E|13__nv_bfloat16|f", m.group(2) or "")]
            args = [a for a in args if a is not None]
            name = m.group(1) + (f"<{','.join(args)}>" if args else "")
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            print(f"ptxas {lib} {name}: {m.group(1)} registers, {spill} bytes spill stores")
            name = None


def find_cuobjdump():
    import shutil

    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.path.exists(cand):
            return cand
    try:
        import triton

        cand = os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin",
                            "cuobjdump")
        return cand if os.path.exists(cand) else None
    except ImportError:
        return None


# SASS instructions each library's design must contain (regex per name):
# bf16 wgmma and TMA loads for K1/K2, s8 wgmma, TMA loads and the bf16
# wgmma core for K3/K4, and for K5 the bf16 wgmma core and the TF32 mma.sync
# of its 3xTF32 float32 routes; and those it must not: no mma.sync (HMMA,
# IMMA) anywhere in the int8 library, which runs on wgmma; and per kernel
# (SASS_PER_KERNEL) every instantiation of KB (a) 1's int8 attention core,
# both routes, and of the int8 row-parallel product's row-strip kernel holds
# s8 wgmma and TMA loads
SASS_OPS = {"HGMMA": r"\bHGMMA\.", "IGMMA": r"\bIGMMA\.", "UTMALDG": r"\bUTMALDG\b",
            "UTMASTG": r"\bUTMASTG\b",
            "HMMA.TF32": r"\bHMMA\.[\w.]*TF32\b", "HMMA": r"\bHMMA\.", "IMMA": r"\bIMMA\."}
SASS_REQUIRED = {"fused_block": ("HGMMA", "UTMALDG"),
                 "fused_block_q": ("IGMMA", "UTMALDG", "HGMMA"),
                 "attention": ("HGMMA", "HMMA.TF32")}
SASS_FORBIDDEN = {"fused_block_q": ("HMMA", "IMMA")}
# the register (attention_qq_kernel<N>, 4 key buckets) and tiled
# (attention_qq_tiled_kernel<NO>, 4 output widths) cores and rows_q_partial's
# row-strip kernel (rows_strip_q_kernel<T, KB>, bf16 and f32, KB = 1-3); the
# bf16 slots' row-strip kernel (gemm_strip_f32_kernel<KB>, KB = 1-6)
SASS_PER_KERNEL = {"fused_block_q": (("attention_qq_", ("IGMMA", "UTMALDG"), 8),
                                     ("rows_strip_q_kernel", ("IGMMA", "UTMALDG"), 6)),
                   "fused_block": (("gemm_strip_f32_kernel", ("HGMMA", "UTMALDG"), 6),)}
# the one-call layer's persistent GEMMs (gemm_s8_tma_kernel, its QKV
# product, and gemm_s8_epi_kernel, its down product; one instantiation
# each): s8 wgmma, TMA loads and TMA stores
SASS_PER_KERNEL_STORE = {"fused_block_q": (
    ("gemm_s8_tma_kernel", ("IGMMA", "UTMALDG", "UTMASTG"), 1),
    ("gemm_s8_epi_kernel", ("IGMMA", "UTMALDG", "UTMASTG"), 1))}


# per kernel of the attention library: each instantiation of the long route
# (attention_long_kernel<T, C>) must hold the instructions of its design and
# none of mma.sync (HMMA.): bf16 wgmma and TMA loads at bf16, tf32 wgmma and
# TMA loads at float32 (3xTF32: Q K^T and P V both on tf32 wgmma)
SASS_LONG = {"bf16": ("HGMMA.BF16", "UTMALDG"), "f32": ("HGMMA.TF32", "UTMALDG")}
SASS_OPS_LONG = {**SASS_OPS, "HGMMA.BF16": r"\bHGMMA\.[\w.]*BF16\b",
                 "HGMMA.TF32": r"\bHGMMA\.[\w.]*TF32\b"}


# cuobjdump -sass of a library, and the split scripts' digests of it, by
# (path, mtime, size): the phases read the int8 library's SASS a dozen times
_SASS_DUMPS: dict = {}
_SASS_DIGESTS: dict = {}


def _lib_key(path):
    """(path, mtime, size) of a library file, None where it is no file."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return os.path.realpath(path), st.st_mtime_ns, st.st_size


def sass_dump(path):
    """cuobjdump -sass of one library, dumped once while the file stays the
    same (a path that is no file is dumped every time); None without
    cuobjdump."""
    tool = find_cuobjdump()
    if tool is None:
        return None
    key = _lib_key(path)
    if key is None or key not in _SASS_DUMPS:
        t = time.perf_counter()
        sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                              check=True).stdout
        if key is None:
            return sass
        _SASS_DUMPS[key] = sass
        print(f"sass: {os.path.basename(str(path))} dumped in {time.perf_counter() - t:.2f} s")
    return _SASS_DUMPS[key]


def split_sass_digests(split, path):
    """``split.S.sass_digests`` (a ``benchmarks_torch`` split script's
    per-kernel SASS digests) of one library from its one dump, computed once
    while the file stays the same."""
    key = _lib_key(path)
    if key is None or key not in _SASS_DIGESTS:
        digests = split.S.sass_digests(path, sass_dump(path))
        if key is None:
            return digests
        _SASS_DIGESTS[key] = digests
    return dict(_SASS_DIGESTS[key])


def sass_functions(path):
    """{mangled kernel name: its SASS} from one cuobjdump -sass of a library
    (the dump, split at each "Function :" header, as -fun gives it kernel by
    kernel); None without cuobjdump."""
    sass = sass_dump(path)
    if sass is None:
        return None
    parts = re.split(r"\n\s*Function : ", sass)[1:]
    return {p.split("\n", 1)[0].strip(): p for p in parts}


def sass_check_long(lib, path) -> None:
    """Each instantiation of attention_long_kernel and attention_wide_kernel
    in one library: SASS_LONG[dtype] present, no HMMA. (mma.sync); a missing
    instantiation or form fails the run.  The attention library (K5) holds
    the heads-first source at bf16 and f32: head dims 64, 128 and 192 (the
    head resident, attention_long_kernel) and the wide-head mode past them
    (attention_wide_kernel); the fused-block libraries (K1, K3) the packed
    source at bf16: padded head dims 64 and 128 (attention_long_kernel, one
    or two 64-dim chunks a block) and any wider one (attention_wide_kernel)."""
    funcs = sass_functions(path)
    if funcs is None:
        print(f"sass long route {lib}: no cuobjdump found: the per-kernel forms are not checked")
        return
    seen = {}
    for name, body in funcs.items():
        m = re.search(r"attention_(long|wide)_kernelI(13__nv_bfloat16|f)(?:Li(\d)E)?Lb([01])E",
                      name)
        if not m:
            continue
        kind = m.group(1)
        dt = "bf16" if m.group(2) == "13__nv_bfloat16" else "f32"
        src = "packed" if m.group(4) == "1" else "heads"
        seen[(kind, dt, src)] = seen.get((kind, dt, src), 0) + 1
        counts = {op: len(re.findall(SASS_OPS_LONG[op], body))
                  for op in SASS_LONG[dt] + ("HMMA",)}
        forms = sorted(set(re.findall(r"\b[HI]G?MMA\.[\w.]+", body)))
        tag = (f"attention_long_kernel<{dt}, {m.group(3)} output chunk(s), {src}>"
               if kind == "long" else f"attention_wide_kernel<{dt}, {src}>")
        print(f"sass {lib} {tag}: {counts}; forms {forms}")
        missing = [op for op in SASS_LONG[dt] if counts[op] == 0]
        check(not missing, f"{tag} has no {missing} instructions in its SASS")
        check(counts["HMMA"] == 0, f"{tag} runs mma.sync (HMMA.)")
    heads = {k: v for k, v in seen.items() if k[2] == "heads"}
    packed = {k: v for k, v in seen.items() if k[2] == "packed"}
    want_packed = {("long", "bf16", "packed"): 2, ("wide", "bf16", "packed"): 1}
    if lib == "attention":
        want = {("long", "bf16", "heads"): 3, ("long", "f32", "heads"): 3,
                ("wide", "bf16", "heads"): 1, ("wide", "f32", "heads"): 1}
        check(heads == want,
              f"long-route instantiations in the {lib} SASS: {heads}, expected {want} (head "
              f"dims 64, 128, 192 resident and the wide-head mode past them)")
    else:
        check(not heads and packed == want_packed,
              f"long-route instantiations in the {lib} SASS: {seen}, expected {want_packed} "
              f"(K1 / K3 past 320 keys or past head dim 128)")


def sass_check(lib, path) -> None:
    """Count SASS_OPS in one library's SASS; any of SASS_REQUIRED[lib] at 0,
    or of SASS_FORBIDDEN[lib] above 0, fails the run."""
    tool = find_cuobjdump()
    if tool is None:
        print("sass: no cuobjdump found (PATH, /usr/local/cuda/bin, triton's package): "
              "the wgmma/TMA/TF32 instruction counts are not checked")
        return
    sass = sass_dump(path)
    counts = {op: len(re.findall(rx, sass)) for op, rx in SASS_OPS.items()}
    forms = sorted(set(re.findall(r"\b[HI]G?MMA\.[\w.]+", sass)))
    print(f"sass {lib} ({os.path.basename(str(path))}): {counts}; forms {forms} "
          f"(cuobjdump {tool})")
    missing = [op for op in SASS_REQUIRED[lib] if counts[op] == 0]
    check(not missing, f"the {lib} library has no {missing} instructions in its SASS")
    present = [op for op in SASS_FORBIDDEN.get(lib, ()) if counts[op] > 0]
    check(not present, f"the {lib} library has {present} (mma.sync) instructions in its SASS")
    if lib in SASS_PER_KERNEL:
        sass_check_per_kernel(lib, path)
    if lib in SASS_PER_KERNEL_STORE:
        sass_check_per_kernel(lib, path, SASS_PER_KERNEL_STORE)


def sass_check_per_kernel(lib, path, table=None) -> None:
    """``table`` (SASS_PER_KERNEL by default)[lib]: for each kernel there,
    every instantiation whose mangled name holds the kernel's name holds
    each of its ops, and there are as many as expected; a missing one, or
    one without an op, fails the run."""
    funcs = sass_functions(path)
    for kernel, ops, want in (table or SASS_PER_KERNEL)[lib]:
        own = {name: {op: len(re.findall(SASS_OPS[op], body)) for op in ops}
               for name, body in funcs.items() if kernel in name}
        print(f"sass {lib}: {ops} per {kernel} instantiation "
              f"{sorted(tuple(c.values()) for c in own.values())}")
        check(len(own) == want, f"{len(own)} {kernel} instantiations in the {lib} SASS, "
              f"expected {want}")
        short = [name for name, c in own.items() if min(c.values()) == 0]
        check(not short, f"{short} lack one of {ops} in their SASS")


def block_params(d, device, seed):
    import torch

    g = torch.Generator().manual_seed(seed)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(device)

    # unit-gain projections (as tests/test_torch_fused_block.py draws them),
    # so the block's contribution is O(1) beside a unit residual
    f = 4 * d
    attn = (1 + 0.1 * rn(d), 0.1 * rn(d), rn(d, 3 * d, std=d ** -0.5),
            0.1 * rn(3 * d), rn(d, d, std=d ** -0.5), 0.1 * rn(d))
    mlp = (1 + 0.1 * rn(d), 0.1 * rn(d), rn(d, f, std=(2 * d) ** -0.5), 0.1 * rn(f),
           rn(f, d, std=f ** -0.5), 0.1 * rn(d))
    return attn, mlp


SPLIT_NAMES = {"gemm_wgmma_kernel<0>": "QKV GEMM", "gemm_wgmma_kernel<1>": "out GEMM",
               "gemm_wgmma_kernel<2>": "up GEMM", "gemm_wgmma_kernel<3>": "up GEMM",
               "gemm_wgmma_kernel<4>": "down GEMM", "gemm_s8_kernel<0>": "QKV GEMM",
               "gemm_s8_kernel<1>": "out GEMM", "gemm_s8_kernel<2>": "up GEMM",
               "gemm_s8_kernel<3>": "up GEMM", "gemm_s8_kernel<4>": "down GEMM",
               "gemm_s8_kernel<8>": "out GEMM", "gemm_s8_kernel<9>": "down GEMM",
               "gemm_s8_kernel<10>": "down GEMM", "gemm_s8_tma_kernel": "QKV GEMM",
               "gemm_s8_epi_kernel": "down GEMM", "gemm_s8_epi_chunk_kernel": "down GEMM",
               "layer_norm_kernel": "LN"}
# the int8 attention block quantizes two bf16 row sets (the LN output and
# the attention output) with one kernel at one shape: the profiler sums them
QUANT_X_ATTN = "quantize x + quantize attn (2 calls)"
SPLIT_ORDER = ["LN", "LN + quantize", "quantize x", QUANT_X_ATTN, "QKV GEMM", "core",
               "quantize attn", "out GEMM", "up GEMM", "quantize h", "gelu + quantize",
               "down GEMM"]


def split_label(key: str) -> str:
    """A block's sub-kernel by its profiler name: the GEMMs by epilogue, the
    quantize pass by its input (bf16 LN output or f32 hidden)."""
    m = re.match(r"^.*?(\w+_kernel)(?:<([^>]*)>)?", key)
    if not m:
        return key
    kernel, args = m.group(1), m.group(2)
    if kernel in ("gemm_s8_kernel", "gemm_wgmma_kernel") and args:
        args = args.split(",")[0].strip()  # the epilogue; not the ragged-edge flag
    short = f"{kernel}<{args}>" if args else kernel
    if short in SPLIT_NAMES:
        return SPLIT_NAMES[short]
    if kernel == "quant_rows_kernel":
        return "quantize x" if "bfloat16" in (args or "") else "quantize h"
    if kernel == "quant_rows_x4_kernel":
        return "quantize h"
    if kernel == "qgelu_quant_rows_kernel":
        return "gelu + quantize"
    if kernel == "ln_quant_rows_kernel":
        return "LN + quantize"
    return "core" if kernel in ("attention_wgmma_kernel", "attention_long_kernel",
                                "attention_wide_kernel") else short


def subkernel_split(name, fn, gemm_ops, card, kind="bf16", iters=5, rename=None):
    """ms per call of each device kernel of one block call (torch.profiler),
    and each GEMM's rate and share of the peak for ``kind`` (bf16 or int8);
    ``rename`` maps a sub-kernel's label to the one printed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    parts = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us <= 0:
            continue
        label = split_label(ev.key)
        label = (rename or {}).get(label, label)
        ms = us / iters / 1e3
        text = f"{label} {ms:.4f} ms"
        if label in gemm_ops:
            rate = gemm_ops[label] / ms / 1e9
            unit = "TFLOP/s" if kind == "bf16" else "TOP/s"
            text += f" ({rate:.1f} {unit}, {rate / (PEAK[kind] / 1e12):.1%} of {kind} peak)"
        parts.append((label, ms, text))
    parts.sort(key=lambda p: SPLIT_ORDER.index(p[0]) if p[0] in SPLIT_ORDER else len(SPLIT_ORDER))
    print(f"split {name}: " + "; ".join(p[2] for p in parts)
          + f"; sum {sum(p[1] for p in parts):.4f} ms ({card})")
    return {p[0]: p[1] for p in parts}


def compare_bf16(name, x, got, ref):
    """A bf16 block kernel's output against its twin's: within 1 bf16 ulp of
    the twin's largest magnitude.  Returns the largest difference."""
    err = (got.float() - ref.float()).abs().max().item()
    mag = ref.float().abs().max().item()
    own = (ref.float() - x.float()).abs().max().item()
    tol = ulp_bf16(mag)
    print(f"kernel {name}: max_abs_err {err} (tolerance {tol} = 1 bf16 ulp of "
          f"max |twin| {mag}; max |twin - x| {own})")
    check(math.isfinite(err) and err <= tol, f"{name}: kernel disagrees with its twin")
    return err


def kernel_phase(fb, device, card):
    """Kernel vs twin at the B=8 shapes, at every key bucket of the attention
    core, at a ragged M, at the main path's B=256 image shapes (timed, split
    by sub-kernel) and at the text tower's B=319 shapes (timed).  Returns the
    JSON rows without launch counts, and the text-shape times."""
    import torch

    compare = compare_bf16
    g = torch.Generator().manual_seed(1)
    for b, s, d, heads, causal in ((8, 197, 768, 12, False), (8, 77, 512, 8, True)):
        attn, mlp = block_params(d, device, seed=d)
        for scale in (1.0, 1 / 16):
            x = (torch.randn(b, s, d, generator=g) * scale).to(device, torch.bfloat16)
            tag = f"B={b} S={s} D={d} x~N(0,{scale}^2)"
            compare(f"attention_block {tag} H={heads} causal={causal}", x,
                    fb.attention_block(x, *attn, heads=heads, causal=causal),
                    fb.attention_block_plain(x, *attn, heads=heads, causal=causal))
            compare(f"mlp_block {tag} F={4 * d} quick_gelu", x,
                    fb.mlp_block(x, *mlp), fb.mlp_block_plain(x, *mlp))
    # SLIP-ViT-L/16's image blocks: D=1024, 16 heads, F=4096, the erf-gelu MLP;
    # their inputs come from a generator of their own, so every ViT-B/16 and
    # text case keeps the draws it had before SLIP-L joined
    attn, mlp = block_params(1024, device, seed=1024)
    g_slip = torch.Generator().manual_seed(1024)
    for scale in (1.0, 1 / 16):
        x = (torch.randn(8, 197, 1024, generator=g_slip) * scale).to(device, torch.bfloat16)
        tag = f"B=8 S=197 D=1024 x~N(0,{scale}^2) (SLIP-L)"
        compare(f"attention_block {tag} H=16 causal=False", x,
                fb.attention_block(x, *attn, heads=16),
                fb.attention_block_plain(x, *attn, heads=16))
        compare(f"mlp_block {tag} F=4096 gelu", x, fb.mlp_block(x, *mlp, act_kind="gelu"),
                fb.mlp_block_plain(x, *mlp, act_kind="gelu"))
    # RN50x4's text blocks: D=640, 10 heads, F=2560, causal (phase 18); inputs
    # from a generator of their own, as SLIP-L's
    attn, mlp = block_params(RN_TEXT[0], device, seed=RN_TEXT[0])
    g_rn = torch.Generator().manual_seed(RN_TEXT[0])
    for scale in (1.0, 1 / 16):
        x = (torch.randn(8, 77, RN_TEXT[0], generator=g_rn) * scale).to(device, torch.bfloat16)
        tag = f"B=8 S=77 D={RN_TEXT[0]} x~N(0,{scale}^2) (RN50x4 text)"
        compare(f"attention_block {tag} H={RN_TEXT[1]} causal=True", x,
                fb.attention_block(x, *attn, heads=RN_TEXT[1], causal=True),
                fb.attention_block_plain(x, *attn, heads=RN_TEXT[1], causal=True))
        compare(f"mlp_block {tag} F={4 * RN_TEXT[0]} quick_gelu", x, fb.mlp_block(x, *mlp),
                fb.mlp_block_plain(x, *mlp))
    # every key bucket of the wgmma core (32, 80, 200, 256, 256 + 64 keys)
    attn, mlp = block_params(512, device, seed=5)
    for s_ in (1, 7, 257, 320):
        for causal in (False, True):
            x = torch.randn(2, s_, 512, generator=g).to(device, torch.bfloat16)
            compare(f"attention_block B=2 S={s_} D=512 H=8 causal={causal}", x,
                    fb.attention_block(x, *attn, heads=8, causal=causal),
                    fb.attention_block_plain(x, *attn, heads=8, causal=causal))
    # a ragged M: 3 x 77 = 231 rows against the GEMM's 128-row tile
    for scale in (1.0, 1 / 16):
        x = (torch.randn(3, 77, 512, generator=g) * scale).to(device, torch.bfloat16)
        tag = f"B=3 S=77 D=512 x~N(0,{scale}^2) (ragged M)"
        for causal in (False, True):
            compare(f"attention_block {tag} H=8 causal={causal}", x,
                    fb.attention_block(x, *attn, heads=8, causal=causal),
                    fb.attention_block_plain(x, *attn, heads=8, causal=causal))
        for act in fb.ACT_KINDS:
            compare(f"mlp_block {tag} F=2048 {act}", x, fb.mlp_block(x, *mlp, act_kind=act),
                    fb.mlp_block_plain(x, *mlp, act_kind=act))
    # past 320 keys: the core's long route (a generator of its own, so every
    # case above keeps its draws)
    attn_l, _ = block_params(768, device, seed=FIT_JOINT_S)
    g_long = torch.Generator().manual_seed(FIT_JOINT_S)
    for s_ in LONG_CORE_S:
        for causal in (False, True):
            for scale in (1.0, 1 / 16):
                x = (torch.randn(8, s_, 768, generator=g_long) * scale).to(device,
                                                                            torch.bfloat16)
                fb.reset_launches()
                got = fb.attention_block(x, *attn_l, heads=12, causal=causal)
                routes = dict(fb.CORE_ROUTES)
                compare(f"attention_block B=8 S={s_} D=768 H=12 x~N(0,{scale}^2) "
                        f"causal={causal} ({fb.core_route(s_)} core)", x, got,
                        fb.attention_block_plain(x, *attn_l, heads=12, causal=causal))
                check(routes == routes_of(fb, s_),
                      f"attention_block S={s_}: core routes {routes}, expected "
                      f"{routes_of(fb, s_)}")
    torch.cuda.synchronize()

    rows = []
    for model, d, heads, act, seed in IMAGE_TOWERS:
        attn, mlp = block_params(d, device, seed=seed)
        x = torch.randn(BATCH, 197, d, generator=g if d == 768 else g_slip
                        ).to(device, torch.bfloat16)
        f, case = 4 * d, f"{model} B={BATCH} S=197 D={d}"
        for name, kern, plain, args, kw, line, work in (
                ("attention_block", fb.attention_block, fb.attention_block_plain, attn,
                 {"heads": heads}, 69, attention_block_work(BATCH, 197, d)),
                ("mlp_block", fb.mlp_block, fb.mlp_block_plain, mlp, {"act_kind": act}, 192,
                 mlp_block_work(BATCH, 197, d, f))):
            err = compare(f"{name} {case} (main path)", x, kern(x, *args, **kw),
                          plain(x, *args, **kw))
            rows.append(kernel_row(name, case, "fused_block", line, err,
                                   cuda_ms(lambda: kern(x, *args, **kw)),
                                   cuda_ms(lambda: plain(x, *args, **kw)), work))
        m = BATCH * 197
        subkernel_split(f"attention_block {case} H={heads}",
                        lambda: fb.attention_block(x, *attn, heads=heads),
                        {"QKV GEMM": 2 * m * d * 3 * d, "out GEMM": 2 * m * d * d}, card)
        subkernel_split(f"mlp_block {case} F={f} {act}",
                        lambda: fb.mlp_block(x, *mlp, act_kind=act),
                        {"up GEMM": 2 * m * d * f, "down GEMM": 2 * m * d * f}, card)
        del x, attn, mlp
    # K1 at the Frozen-in-Time joint tower's measurement shapes, B=32 S=785:
    # the block timed, and its long core against the core's own bound
    x = torch.randn(32, FIT_JOINT_S, 768, generator=g_long).to(device, torch.bfloat16)
    case = f"FiT joint B=32 S={FIT_JOINT_S} D=768 (long core)"
    err = compare(f"attention_block {case}", x, fb.attention_block(x, *attn_l, heads=12),
                  fb.attention_block_plain(x, *attn_l, heads=12))
    long_row = kernel_row("attention_block", case, "fused_block", 69, err,
                          cuda_ms(lambda: fb.attention_block(x, *attn_l, heads=12), iters=5),
                          cuda_ms(lambda: fb.attention_block_plain(x, *attn_l, heads=12),
                                  iters=3),
                          attention_block_work(32, FIT_JOINT_S, 768))
    parts = subkernel_split(f"attention_block {case} H=12",
                            lambda: fb.attention_block(x, *attn_l, heads=12),
                            {"QKV GEMM": 2 * 32 * FIT_JOINT_S * 768 * 3 * 768,
                             "out GEMM": 2 * 32 * FIT_JOINT_S * 768 * 768}, card)
    long_row["core_ms"] = parts.get("core")
    del x
    # the bf16 text tower's shapes (causal attention), timed too
    attn_t, mlp_t = block_params(512, device, seed=11)
    xt = torch.randn(319, 77, 512, generator=g).to(device, torch.bfloat16)
    compare("attention_block B=319 S=77 D=512 H=8 causal", xt,
            fb.attention_block(xt, *attn_t, heads=8, causal=True),
            fb.attention_block_plain(xt, *attn_t, heads=8, causal=True))
    compare("mlp_block B=319 S=77 D=512 F=2048 quick_gelu", xt,
            fb.mlp_block(xt, *mlp_t), fb.mlp_block_plain(xt, *mlp_t))
    text_ms = {
        "attention_block causal": (
            cuda_ms(lambda: fb.attention_block(xt, *attn_t, heads=8, causal=True)),
            cuda_ms(lambda: fb.attention_block_plain(xt, *attn_t, heads=8, causal=True))),
        "mlp_block": (cuda_ms(lambda: fb.mlp_block(xt, *mlp_t)),
                      cuda_ms(lambda: fb.mlp_block_plain(xt, *mlp_t))),
    }
    # RN50x4's text tower at the 319 prompts: rows of the kernels line
    # (launches: phase 18)
    d, heads = RN_TEXT
    attn_r, mlp_r = block_params(d, device, seed=d + 1)
    xr = torch.randn(319, 77, d, generator=g_rn).to(device, torch.bfloat16)
    case = f"RN50x4 text B=319 S=77 D={d}"
    for name, kern, plain, args, kw, line, work in (
            ("attention_block", fb.attention_block, fb.attention_block_plain, attn_r,
             {"heads": heads, "causal": True}, 69,
             attention_block_work(319, 77, d, causal=True)),
            ("mlp_block", fb.mlp_block, fb.mlp_block_plain, mlp_r, {}, 192,
             mlp_block_work(319, 77, d, 4 * d))):
        err = compare(f"{name} {case} (phase 18's prompts)", xr, kern(xr, *args, **kw),
                      plain(xr, *args, **kw))
        rows.append(kernel_row(name, case, "fused_block", line, err,
                               cuda_ms(lambda: kern(xr, *args, **kw)),
                               cuda_ms(lambda: plain(xr, *args, **kw)), work))
    return rows, text_ms, long_row


def kernel_row(name, case, lib, line, err, ms, plain_ms, work):
    """One kernels-line row of a fused-block kernel (K1-K4), launches unset."""
    bound_ms, bound_by = bound(*work)
    return {"name": name, "case": case, "route": "cuda",
            "source": f"debias_vision_lang_torch/csrc/{lib}.cu",
            "replaces": f"debias_vision_lang_tpu/ops/{lib}.py:{line}",
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def q_block_params(d, device, seed):
    """block_params with the four weights quantized by the port's
    quantize_weight: (positional args, the kernels' transposed copies)."""
    from debias_vision_lang_torch.ops.quant import QWeight

    (ls, lb, wqkv, bqkv, wo, bo), (l2s, l2b, w1, b1, w2, b2) = block_params(d, device, seed)
    wqkv, wo, w1, w2 = map(QWeight, (wqkv, wo, w1, w2))
    return (((ls, lb, wqkv.q, wqkv.scale, bqkv, wo.q, wo.scale, bo),
             {"wqkv_qt": wqkv.qt, "wo_qt": wo.qt}),
            ((l2s, l2b, w1.q, w1.scale, b1, w2.q, w2.scale, b2),
             {"w1_qt": w1.qt, "w2_qt": w2.qt}))


def k4_ln_rows(fbq, sk, x, block, kw=None):
    """An int8 entry's scratch with its LayerNorm rows: where it normalises
    and quantizes x in one pass and writes none (K4's F-split, KB (a) 2 and
    3, and q_ilp4's attention on the card), K4's (an MLP's: hq) or K3's (an
    attention's: aq, at kw's heads) own LayerNorm rows of the same x (the
    same LayerNorm kernel's rows bit for bit, so its x codes are their
    quantization), K4's or K3's launch left out of the counters."""
    if "xn" in sk or ("hq" not in sk and "aq" not in sk):
        return sk
    args, qkw = block
    s4, counts, routes = {}, dict(fbq.LAUNCHES), dict(fbq.CORE_ROUTES)
    if "hq" in sk:
        fbq.mlp_block_q(x, *args, **qkw, scratch=s4)
    else:
        fbq.attention_block_q(x, *args, heads=kw["heads"], **qkw, scratch=s4)
    fbq.LAUNCHES.update(counts)
    fbq.CORE_ROUTES.update(routes)
    return {**sk, "xn": s4["xn"]}


def compare_q(fbq, name, kern, plain, x, block, kw, long_core=False, quant=None):
    """An int8 block kernel against its twin: the output within 1 bf16 ulp of
    the twin's largest magnitude (past 320 keys: K3's attention rows and its
    own codes' out-projection), every code the twin's quantizer (``quant``,
    quant_rows by default) of the kernel's own rows, and the share of codes
    off the twin's under CODE_SHARE_MAX.  Returns the largest output
    difference."""
    import torch

    quant = quant or fbq.quant_rows

    args, qkw = block
    sk, sr = {}, {}
    got = kern(x, *args, **kw, **qkw, scratch=sk)
    ref = plain(x, *args, **kw, scratch=sr)
    sk = k4_ln_rows(fbq, sk, x, block, kw)
    err = (got.float() - ref.float()).abs().max().item()
    mag = ref.float().abs().max().item()
    own = (ref.float() - x.float()).abs().max().item()
    tol = ulp_bf16(mag)
    print(f"kernel {name}: max_abs_err {err} (tolerance {tol} = 1 bf16 ulp of "
          f"max |twin| {mag}; max |twin - x| {own})")
    if long_core:
        # the long core's own rows against the twin's core, and the
        # output against the twin's last step on the kernel's own codes
        core_err = (sk["attn"] - sr["attn"]).abs().max().item()
        core_tol = ulp_bf16(sr["attn"].abs().max().item())
        own_codes = (x.float() + (fbq.dot_q(sk["aq"], sk["as"], args[5], args[6])
                                  + args[7].float())).to(x.dtype)
        code_err = (got.float() - own_codes.float()).abs().max().item()
        code_tol = ulp_bf16(own_codes.float().abs().max().item())
        print(f"  long core: attention rows vs the twin's max |diff| {core_err} (bar "
              f"{core_tol}, 1 bf16 ulp); output vs the twin's out-projection of the "
              f"kernel's own codes {code_err} (bar {code_tol})"
              + ("; past 1 ulp of the twin only through codes the code bar admits"
                 if err > tol else ""))
        check(core_err <= core_tol, f"{name}: the long core disagrees with the twin's")
        check(code_err <= code_tol, f"{name}: the out-projection of its own codes is off")
    else:
        check(math.isfinite(err) and err <= tol, f"{name}: kernel disagrees with its twin")
    check(math.isfinite(err), f"{name}: non-finite output")
    n_codes = n_diff = 0
    for codes, rows, scales in (("xq", "xn", "xs"), ("aq", "attn", "as"), ("hq", "h", "hs")):
        if codes not in sk:
            continue
        q, s = quant(sk[rows])
        check(torch.equal(q, sk[codes]) and torch.equal(s, sk[scales]),
              f"{name}: the kernel's {codes} codes are not the quantization of "
              f"its own {rows} rows")
        diff = (sk[codes].int() - sr[codes].int()).abs()
        worst, n = diff.max().item(), diff.ne(0).sum().item()
        print(f"  {codes} codes: the quantization of the kernel's own {rows} rows; "
              f"{n / diff.numel():.3e} differ from the twin's, max |diff| {worst} "
              f"(bar {CODE_DIFF_MAX[codes]})")
        check(worst <= CODE_DIFF_MAX[codes], f"{name}: {codes} codes off by {worst}")
        n_codes, n_diff = n_codes + diff.numel(), n_diff + n
    print(f"  all codes: {n_diff / n_codes:.3e} differ (bar {CODE_SHARE_MAX})")
    check(n_diff / n_codes <= CODE_SHARE_MAX, f"{name}: int8 codes drift from the twin's")
    return err


def kernel_phase_q(fbq, device, card):
    """attention_block_q / mlp_block_q against their twins at the B=8 shapes
    (x and x/16, and a gelu MLP), attention_block_q at both sides of every
    key bucket of the wgmma core, both blocks at a ragged M (x and x/16;
    causal and not, both activations), at the int8 main path's B=256 image
    shapes (timed; both blocks split by sub-kernel) and at the int8 text
    tower's B=319 shapes (timed).  Returns the JSON rows without launch
    counts, and the text-shape times."""
    import torch

    def compare(*a, **k):
        return compare_q(fbq, *a, **k)

    attn_fns = (fbq.attention_block_q, fbq.attention_block_q_plain)
    mlp_fns = (fbq.mlp_block_q, fbq.mlp_block_q_plain)
    g = torch.Generator().manual_seed(2)
    for b, s, d, heads, causal in ((8, 197, 768, 12, False), (8, 77, 512, 8, True)):
        attn, mlp = q_block_params(d, device, seed=d)
        for scale in (1.0, 1 / 16):
            x = (torch.randn(b, s, d, generator=g) * scale).to(device, torch.bfloat16)
            tag = f"B={b} S={s} D={d} x~N(0,{scale}^2)"
            compare(f"attention_block_q {tag} H={heads} causal={causal}", *attn_fns, x, attn,
                    {"heads": heads, "causal": causal})
            compare(f"mlp_block_q {tag} F={4 * d} quick_gelu", *mlp_fns, x, mlp, {})
        if not causal:
            x = torch.randn(b, s, d, generator=g).to(device, torch.bfloat16)
            compare(f"mlp_block_q B={b} S={s} D={d} F={4 * d} gelu", *mlp_fns, x, mlp,
                    {"act_kind": "gelu"})
    # SLIP-ViT-L/16's image blocks: D=1024, 16 heads, F=4096 (the
    # widest hidden row the quantize pass holds in registers), the erf-gelu MLP; inputs
    # from a generator of their own, as in phase 3
    attn, mlp = q_block_params(1024, device, seed=1024)
    g_slip = torch.Generator().manual_seed(1025)
    for scale in (1.0, 1 / 16):
        x = (torch.randn(8, 197, 1024, generator=g_slip) * scale).to(device, torch.bfloat16)
        tag = f"B=8 S=197 D=1024 x~N(0,{scale}^2) (SLIP-L)"
        compare(f"attention_block_q {tag} H=16 causal=False", *attn_fns, x, attn,
                {"heads": 16})
        compare(f"mlp_block_q {tag} F=4096 gelu", *mlp_fns, x, mlp, {"act_kind": "gelu"})
    # RN50x4's text blocks under "int8-text": D=640, 10 heads, F=2560, causal
    d, heads = RN_TEXT
    attn, mlp = q_block_params(d, device, seed=d)
    g_rn = torch.Generator().manual_seed(d + 2)
    for scale in (1.0, 1 / 16):
        x = (torch.randn(8, 77, d, generator=g_rn) * scale).to(device, torch.bfloat16)
        tag = f"B=8 S=77 D={d} x~N(0,{scale}^2) (RN50x4 text)"
        compare(f"attention_block_q {tag} H={heads} causal=True", *attn_fns, x, attn,
                {"heads": heads, "causal": True})
        compare(f"mlp_block_q {tag} F={4 * d} quick_gelu", *mlp_fns, x, mlp, {})
    # both sides of every key bucket of the wgmma core (32, 80, 200, 256,
    # 256 + 64 keys)
    attn, mlp = q_block_params(512, device, seed=5)
    for s_ in (1, 7, 200, 201, 256, 257, 320):
        for causal in (False, True):
            x = torch.randn(2, s_, 512, generator=g).to(device, torch.bfloat16)
            compare(f"attention_block_q B=2 S={s_} D=512 H=8 causal={causal}", *attn_fns, x,
                    attn, {"heads": 8, "causal": causal})
    # a ragged M: 3 x 77 = 231 rows against the s8 GEMM's 128-row tile
    for scale in (1.0, 1 / 16):
        x = (torch.randn(3, 77, 512, generator=g) * scale).to(device, torch.bfloat16)
        tag = f"B=3 S=77 D=512 x~N(0,{scale}^2) (ragged M)"
        for causal in (False, True):
            compare(f"attention_block_q {tag} H=8 causal={causal}", *attn_fns, x, attn,
                    {"heads": 8, "causal": causal})
        for act in ("quick_gelu", "gelu"):
            compare(f"mlp_block_q {tag} F=2048 {act}", *mlp_fns, x, mlp, {"act_kind": act})
    # past 320 keys: the core's long route (a generator of its own)
    attn_l, mlp_l = q_block_params(768, device, seed=FIT_JOINT_S)
    g_long = torch.Generator().manual_seed(FIT_JOINT_S + 1)
    for s_ in LONG_CORE_S:
        for causal in (False, True):
            for scale in (1.0, 1 / 16):
                x = (torch.randn(8, s_, 768, generator=g_long) * scale).to(device,
                                                                            torch.bfloat16)
                fbq.reset_launches()
                compare(f"attention_block_q B=8 S={s_} D=768 H=12 x~N(0,{scale}^2) "
                        f"causal={causal} ({fbq.core_route(s_)} core)", *attn_fns, x, attn_l,
                        {"heads": 12, "causal": causal}, long_core=s_ > 320)
                check(fbq.CORE_ROUTES == routes_of(fbq, s_),
                      f"attention_block_q S={s_}: core routes {fbq.CORE_ROUTES}, expected "
                      f"{routes_of(fbq, s_)}")
    torch.cuda.synchronize()

    rows = []
    for model, d, heads, act, seed in IMAGE_TOWERS:
        attn, mlp = q_block_params(d, device, seed=seed)
        x = torch.randn(BATCH, 197, d, generator=g if d == 768 else g_slip
                        ).to(device, torch.bfloat16)
        f, case = 4 * d, f"{model} B={BATCH} S=197 D={d}"
        for name, (kern, plain), block, kw, line, work in (
                ("attention_block_q", attn_fns, attn, {"heads": heads}, 62,
                 attention_block_work(BATCH, 197, d, weights="int8")),
                ("mlp_block_q", mlp_fns, mlp, {"act_kind": act}, 106,
                 mlp_block_work(BATCH, 197, d, f, weights="int8"))):
            err = compare(f"{name} {case} (int8 main path)", kern, plain, x, block, kw)
            rows.append(kernel_row(name, case, "fused_block_q", line, err,
                                   cuda_ms(lambda: kern(x, *block[0], **kw, **block[1])),
                                   cuda_ms(lambda: plain(x, *block[0], **kw)), work))
        m = BATCH * 197
        subkernel_split(f"attention_block_q {case} H={heads}",
                        lambda: fbq.attention_block_q(x, *attn[0], heads=heads, **attn[1]),
                        {"QKV GEMM": 2 * m * d * 3 * d, "out GEMM": 2 * m * d * d}, card,
                        kind="int8", rename={"quantize x": QUANT_X_ATTN})
        subkernel_split(f"mlp_block_q {case} F={f} {act}",
                        lambda: fbq.mlp_block_q(x, *mlp[0], act_kind=act, **mlp[1]),
                        {"up GEMM": 2 * m * d * f, "down GEMM": 2 * m * d * f}, card,
                        kind="int8")
        del x, attn, mlp
    # K3 and K4 at the int8 joint Frozen-in-Time tower's shapes, B=32 S=785:
    # timed (rows of the kernels line, launches: phase 19), K3's long core
    # against the core's own bound
    x = torch.randn(32, FIT_JOINT_S, 768, generator=g_long).to(device, torch.bfloat16)
    case = f"FiT joint B=32 S={FIT_JOINT_S} D=768 (long core)"
    for name, (kern, plain), block, kw, line, work in (
            ("attention_block_q", attn_fns, attn_l, {"heads": 12}, 62,
             attention_block_work(32, FIT_JOINT_S, 768, weights="int8")),
            ("mlp_block_q", mlp_fns, mlp_l, {"act_kind": "gelu"}, 106,
             mlp_block_work(32, FIT_JOINT_S, 768, 3072, weights="int8"))):
        core = name == "attention_block_q"
        row_case = case if core else case.replace(" (long core)", "")
        err = compare(f"{name} {row_case} (int8 joint tower)", kern, plain, x, block, kw,
                      long_core=core)
        rows.append(kernel_row(name, row_case, "fused_block_q", line, err,
                               cuda_ms(lambda: kern(x, *block[0], **kw, **block[1]), iters=5),
                               cuda_ms(lambda: plain(x, *block[0], **kw), iters=3), work))
    m = 32 * FIT_JOINT_S
    parts = subkernel_split(f"attention_block_q {case} H=12",
                            lambda: fbq.attention_block_q(x, *attn_l[0], heads=12, **attn_l[1]),
                            {"QKV GEMM": 2 * m * 768 * 3 * 768, "out GEMM": 2 * m * 768 * 768},
                            card, kind="int8", rename={"quantize x": QUANT_X_ATTN})
    rows[-2]["core_ms"] = parts.get("core")
    del x
    # the int8 text tower's shapes (causal attention), timed too
    attn_t, mlp_t = q_block_params(512, device, seed=11)
    xt = torch.randn(319, 77, 512, generator=g).to(device, torch.bfloat16)
    compare("attention_block_q B=319 S=77 D=512 H=8 causal", *attn_fns, xt, attn_t,
            {"heads": 8, "causal": True})
    compare("mlp_block_q B=319 S=77 D=512 F=2048 quick_gelu", *mlp_fns, xt, mlp_t, {})
    ca = {"heads": 8, "causal": True}
    text_ms = {
        "attention_block_q causal": (
            cuda_ms(lambda: fbq.attention_block_q(xt, *attn_t[0], **ca, **attn_t[1])),
            cuda_ms(lambda: fbq.attention_block_q_plain(xt, *attn_t[0], **ca))),
        "mlp_block_q": (cuda_ms(lambda: fbq.mlp_block_q(xt, *mlp_t[0], **mlp_t[1])),
                        cuda_ms(lambda: fbq.mlp_block_q_plain(xt, *mlp_t[0]))),
    }
    # RN50x4's int8 text tower at the 319 prompts (launches: phase 18)
    d, heads = RN_TEXT
    attn_r, mlp_r = q_block_params(d, device, seed=d + 1)
    xr = torch.randn(319, 77, d, generator=g_rn).to(device, torch.bfloat16)
    case = f"RN50x4 text B=319 S=77 D={d}"
    for name, (kern, plain), block, kw, line, work in (
            ("attention_block_q", attn_fns, attn_r, {"heads": heads, "causal": True}, 62,
             attention_block_work(319, 77, d, causal=True, weights="int8")),
            ("mlp_block_q", mlp_fns, mlp_r, {}, 106,
             mlp_block_work(319, 77, d, 4 * d, weights="int8"))):
        err = compare(f"{name} {case} (phase 18's prompts)", kern, plain, xr, block, kw)
        rows.append(kernel_row(name, case, "fused_block_q", line, err,
                               cuda_ms(lambda: kern(xr, *block[0], **kw, **block[1])),
                               cuda_ms(lambda: plain(xr, *block[0], **kw)), work))
    return rows, text_ms


def check_metrics(tag, labels, img_embs, prompt_embs, eval_ranking):
    """Metrics at top-n 100% and 10% from the device engine: finite, equal to
    the numpy oracle, and MaxSkew of the top 10% > 0."""
    metrics = {f"{ev}@{topn}": eval_ranking(labels, img_embs, prompt_embs, ev, topn)
               for ev in ("maxskew", "ndkl") for topn in TOPNS}
    print(f"{tag} metrics: {json.dumps(metrics)}")
    check(all(math.isfinite(v) for m in metrics.values() for v in m.values()),
          f"{tag}: non-finite metrics")
    check(metrics[f"maxskew@{TOPNS[1]}"]["eq_opp"] > 0,
          f"{tag}: MaxSkew of the top 10% is 0: the ranking is degenerate")
    for key, m in metrics.items():
        ev, topn = key.split("@")
        ref = eval_ranking(labels, img_embs, prompt_embs, ev, float(topn),
                           engine="oracle")
        for k, v in m.items():
            check(abs(v - ref[k]) <= METRIC_ATOL,
                  f"{tag} {key}/{k}: device {v} vs oracle {ref[k]}")
    print(f"{tag} metrics agree with the numpy oracle within {METRIC_ATOL}")


def cosine_check(tag, got, ref):
    import torch

    cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1)
    print(f"{tag}: cosine min {cos.min().item():.6f} mean {cos.mean().item():.6f} "
          f"(bar: min >= {COS_MIN})")
    check(bool(torch.isfinite(got).all()), f"{tag}: non-finite embeddings")
    check(cos.min().item() >= COS_MIN, f"{tag}: drift from float32")


def kernel_phase_attn(A, device):
    """attention_pallas (K5) against attention_kernel_math, float32 and
    bfloat16: at the image and text shapes and the long route's B=8 and B=32
    H=12 S=785 (timed, beside SDPA), then at both sides of every key bucket of
    the short routes, at the long route's shapes and a ragged B*H (checked
    only).  Every call's launch lands on the route ``_plan`` gives its shape.
    Returns one dict per timed case."""
    import torch
    from debias_vision_lang_torch.models.layers import causal_mask

    g = torch.Generator().manual_seed(3)
    routes = {"short": "attention_pallas", "long": "attention_pallas_long"}

    def run_case(dtype, b, h, s, kind, hd=64, shift=0.0):
        q, k, v = (torch.randn(b, h, s, hd, generator=g).to(device, dtype) for _ in range(3))
        mask = {"zero": lambda: torch.zeros(s, s),
                "random": lambda: torch.randn(s, s, generator=g),
                "causal": lambda: causal_mask(s)}[kind]().add(shift).to(device)
        route = A._plan(s, hd)
        A.reset_launches()
        got = A.attention_pallas(q, k, v, mask)
        launched = dict(A.LAUNCHES)
        ref = A.attention_kernel_math(q, k, v, mask)
        err = (got.float() - ref.float()).abs().max().item()
        mag = ref.float().abs().max().item()
        f32 = dtype == torch.float32
        tol = 2e-5 * mag if f32 else ulp_bf16(mag)
        tag = (f"attention_pallas {'f32' if f32 else 'bf16'} B={b} H={h} S={s}"
               f"{'' if hd == 64 else f' hd={hd}'} mask={kind}"
               f"{f' + {shift:g}' if shift else ''} ({route} route)")
        print(f"kernel {tag}: max_abs_err {err} (tolerance {tol} = "
              f"{'2e-5 x' if f32 else '1 bf16 ulp of'} max |twin| {mag}); launches {launched}")
        check(got.dtype == dtype and got.shape == q.shape and math.isfinite(err) and err <= tol,
              f"{tag}: kernel disagrees with its twin")
        check(launched == {n: int(r == route) for r, n in routes.items()},
              f"{tag}: launches {launched}, expected one on the {route} route")
        return tag, (q, k, v, mask), err, route

    cases = [(8, 12, 197, "zero"), (8, 12, 197, "random"), (64, 12, 197, "zero"),
             (64, 12, 197, "random"), (319, 8, 77, "causal"), (64, 8, 77, "causal"),
             (8, 12, 785, "zero"), (8, 12, 785, "random"), (32, 12, 785, "zero")]
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        for b, h, s, kind in cases:
            tag, (q, k, v, mask), err, route = run_case(dtype, b, h, s, kind)
            lib_mask = mask.to(dtype)
            out.append({"tag": tag, "dtype": "f32" if f32 else "bf16", "b": b, "h": h, "s": s,
                        "mask": kind, "route": route, "err": err,
                        "ms": cuda_ms(lambda: A.attention_pallas(q, k, v, mask)),
                        "plain_ms": cuda_ms(lambda: A.attention_kernel_math(q, k, v, mask)),
                        "library_ms": cuda_ms(lambda: torch.nn.functional.
                                              scaled_dot_product_attention(
                                                  q, k, v, attn_mask=lib_mask)),
                        "bound": bound(*attention_work(b, h, s, f32)),
                        "bound_cuda_cores": bound(*attention_work(b, h, s, f32, True))
                        if f32 else None})
    # both sides of every key bucket of the short routes (32, 80, 200, 256,
    # 320 keys); the long route past 320 keys and at head dims other than
    # 64; and a B*H that is no multiple of anything the kernels tile by
    for dtype in (torch.float32, torch.bfloat16):
        for s in (1, 7, 32, 33, 80, 81, 200, 201, 256, 257, 320):
            for kind in ("zero", "causal"):
                run_case(dtype, 2, 8, s, kind)
        run_case(dtype, 3, 5, 197, "random")
        # the long route: a ragged last key tile, the 127 / 128 / 129-query
        # block edges, 16 and 32 key tiles; head dims padded to 64, 128, 192
        for s in (321, 383, 384, 385, 400, 785, 1025, 2048):
            for kind in ("zero", "random", "causal"):
                run_case(dtype, 2, 8, s, kind)
        for s in (77, 197):
            for hd in (32, 80, 128, 192):
                run_case(dtype, 2, 8, s, "random", hd=hd)
        run_case(dtype, 2, 8, 785, "random", hd=192)
        run_case(dtype, 3, 5, 785, "random")
    # every score shifted by 1e6 (softmax is shift-invariant; the scores'
    # f32 grid is then 1/16): the bf16 long route's exp takes s - max first
    # and must not cancel against a large max
    run_case(torch.bfloat16, 2, 8, 785, "random", shift=1e6)
    torch.cuda.synchronize()
    return out


def long_route_path(A, device):
    """The long route on the path a Frozen-in-Time joint tower runs: 12
    layers of the public op ``attention(..., use_pallas=True)`` (no mask)
    over its 1 + 4 x 196 = 785 tokens at B=8 H=12 head dim 64, each layer
    h = layer_norm(h + attention(h, h, h)); float32 forward and backward (the K5
    training path: the backward differentiates the twin) and bfloat16
    forward.  The launch counters are set to 0 just before each run and
    read just after: 12 launches on the long route, none on the short one.
    Returns {"f32": launches, "bf16": launches}."""
    import torch

    g = torch.Generator().manual_seed(11)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        x0 = torch.randn(8, 12, 785, 64, generator=g).to(device, dtype).requires_grad_(f32)
        torch.cuda.synchronize()
        A.reset_launches()
        h = x0
        with torch.set_grad_enabled(f32):
            for _ in range(LAYERS):
                h = torch.nn.functional.layer_norm(
                    h + A.attention(h, h, h, use_pallas=True), (h.shape[-1],))
            grad = torch.autograd.grad(h.float().square().mean(), x0)[0] if f32 else None
        torch.cuda.synchronize()
        launched = dict(A.LAUNCHES)
        tag = "f32 forward + backward" if f32 else "bf16 forward"
        print(f"K5 long route path (Frozen-in-Time joint tower attention, B=8 H=12 S=785, "
              f"{LAYERS} layers, {tag}): launches {launched}")
        check(launched == {"attention_pallas": 0, "attention_pallas_long": LAYERS},
              f"the long route path launched {launched}, expected {LAYERS} long")
        check(bool(torch.isfinite(h).all()) and (grad is None or bool(torch.isfinite(grad).all())),
              f"the long route path ({tag}) gave non-finite values")
        out["f32" if f32 else "bf16"] = launched["attention_pallas_long"]
    return out


def ingest_path() -> str:
    """Which path decodes image files: the port's native ingest, or PIL when
    this machine lacks the codec headers (libjpeg, libpng) it compiles
    against.  Any other build or load failure of the port's own library
    fails the run: the loaders would hide it behind the Python path."""
    from debias_vision_lang_torch import native

    if native.available():
        print("native ingest: available (decode, resize, crop and staging in C++)")
        return "native ingest"
    err = native.build_error() or ""
    headers = re.findall(r"fatal error: (\w+\.h): No such file", err)
    print(f"native ingest: available False; build error: {err.strip()[-600:]}")
    check(bool(headers) and set(headers) <= {"jpeglib.h", "png.h"},
          "the port's native ingest library failed to build or load for a reason other "
          "than missing codec headers: the loaders would silently take the Python path")
    print(f"native ingest: this machine has no {', '.join(headers)}; image files are decoded "
          f"by PIL, and every wall time below that reads files says so")
    return "PIL decode (no codec headers for the native ingest)"


def reset_all(*modules):
    for m in modules:
        m.reset_launches()


def nonzero(launches):
    return {k: v for k, v in launches.items() if v}


def launches_of(*modules):
    out = {}
    for m in modules:
        out.update(m.LAUNCHES)
    return out


def train_batches(tokenizer, vis, device):
    """TRAIN_STEPS seeded (images, labels, caption images, caption tokens)
    batches, images preprocessed on the card (float32 NHWC)."""
    import torch
    from debias_vision_lang_torch.vision.preprocess import preprocess_batch

    faces = SyntheticFaces(2 * TRAIN_BATCH * TRAIN_STEPS, seed=100)

    def images(start):
        u8 = np.stack([faces.load_image(start + j) for j in range(TRAIN_BATCH)])
        return preprocess_batch(torch.from_numpy(u8).to(device), vis.image_size,
                                mean=vis.image_mean, std=vis.image_std)

    out = []
    for i in range(TRAIN_STEPS):
        base = 2 * TRAIN_BATCH * i
        caps = tokenizer([f"a photo of person number {base + j}" for j in range(TRAIN_BATCH)])
        out.append((images(base), (np.arange(TRAIN_BATCH) % 2).astype(np.float32),
                    images(base + TRAIN_BATCH), caps))
    return out


def run_trainer(model0, sens, batches, counters, **kw):
    """TRAIN_STEPS trainer steps on a copy of ``model0``; the launch counts
    are set to 0 just before and read just after.  ``kw``: use_pallas, mesh,
    on_step (called with the trainer after each step) and the TrainConfig
    fields."""
    import torch
    from debias_vision_lang_torch.models.adversary import Adversary
    from debias_vision_lang_torch.train.adversarial import AdversarialTrainer, TrainConfig

    use_pallas = kw.pop("use_pallas", None)
    mesh = kw.pop("mesh", None)
    on_step = kw.pop("on_step", None)
    model = copy.deepcopy(model0)
    adv = Adversary.from_cfg({"ADV_N_INPUT": len(sens), "ADV_HIDDEN_SIZE": 32, "SEED": 0})
    trainer = AdversarialTrainer.create(model, adv, TrainConfig(batch_size=TRAIN_BATCH, **kw),
                                        sens, use_pallas=use_pallas, mesh=mesh)
    start = model.debias_tokens.detach().clone()
    metrics, times, updates, grads = [], [], [], []
    adam_step = trainer.prompt_opt.step

    def recording_step(g):  # keeps the first prompt step's token gradient
        if not grads:
            grads.append(g[0].detach().flatten().clone())
        adam_step(g)

    trainer.prompt_opt.step = recording_step
    torch.cuda.synchronize()
    reset_all(*counters)
    for batch in batches:
        before = model.debias_tokens.detach().clone()
        t0 = time.perf_counter()
        metrics.append(trainer.step(*batch))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        updates.append((model.debias_tokens.detach() - before).flatten())
        if on_step is not None:
            on_step(trainer)
    counts = launches_of(*counters)
    moved = (model.debias_tokens.detach() - start).abs().max().item()
    return {"trainer": trainer, "model": model, "metrics": metrics, "times": times,
            "updates": updates, "grad": grads[0], "counts": counts, "moved": moved}


def cosine(a, b) -> float:
    import torch

    return torch.nn.functional.cosine_similarity(a.double().flatten(), b.double().flatten(),
                                                 dim=0).item()


def check_run(tag, run):
    for i, m in enumerate(run["metrics"]):
        print(f"{tag} step {i + 1}: loss {m['loss']} adv_loss {m['adv_loss']} "
              f"contrastive {m['contrastive_loss']} adversary_bce {m['adversary_bce']} "
              f"({run['times'][i] * 1e3:.1f} ms host clock)")
        check(all(math.isfinite(m[k]) for k in ("loss", "adv_loss", "contrastive_loss",
                                               "adversary_bce")), f"{tag}: non-finite loss")
    print(f"{tag}: launches {run['counts']}; tokens moved by up to {run['moved']}")
    check(run["moved"] > 0, f"{tag}: the prompt array did not move")


def write_fairface(root, n_train, n_val, px=224, seed=0):
    """A seeded synthetic FairFace layout (labels/{mode}/{mode}_labels.csv,
    imgs/train_val/...), genders alternating so the balanced split keeps
    every row."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    races = ["White", "Southeast Asian", "Middle Eastern", "Black", "Indian",
             "Latino_Hispanic", "East Asian"]
    ages = ["0-2", "3-9", "10-19", "20-29", "30-39", "40-49", "50-59", "60-69",
            "more than 70"]
    os.makedirs(os.path.join(root, "imgs", "train_val", "synth"))
    for mode, n in (("train", n_train), ("val", n_val)):
        rows = []
        for i in range(n):
            f = f"synth/{mode}_{i}.jpg"
            Image.fromarray(rng.integers(0, 256, (px, px, 3), dtype=np.uint8)).save(
                os.path.join(root, "imgs", "train_val", f), quality=95)
            rows.append({"file": f, "age": ages[i % 9],
                         "gender": "Male" if i % 2 else "Female", "race": races[i % 7]})
        d = os.path.join(root, "labels", mode)
        os.makedirs(d)
        with open(os.path.join(d, f"{mode}_labels.csv"), "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=["file", "age", "gender", "race"])
            w.writeheader()
            w.writerows(rows)


CACHE_VAL = 512  # phase 14's val images: two batches of 256 at 224 px
ABLATION_SEEDS = (0, 1, 2)  # phase 15 stops at the first valid world
# phase 15's witnesses, the card against the CPU from one start
# the step-0 pretraining loss and every gradient tensor: 1e-5 of its largest
# magnitude, at least 1e-5 (float32 sums in another order on the card)
GRAD0_RTOL = 1e-5
STEP3_ATOL = 1e-4  # the loss after 3 Adam steps
# and the 3 steps' update, as a cosine over every parameter: Adam scales an
# element's step to about lr whatever its gradient, so an element whose
# gradient is float noise (the key biases' exact gradient is 0) may step
# another way on each device; no per-element bar holds below 2 lr a step
STEP3_UPDATE_COS = 0.9999
ARM_ATOL = 1e-3  # an arm's NDKL and MaxSkew, before, after and at every eval
PROBE_ATOL = 1e-2  # an arm's probe accuracy (a few of its ~500 rows)


def cache_phase(model, tokenizer, decode, card):
    """Phase 14: measure_bias(cache_embeddings=...) on the phase-4 model and a
    written FairFace val layout."""
    import shutil

    import torch
    from debias_vision_lang_torch.eval import measure as M
    from debias_vision_lang_torch.ops import attention as A
    from debias_vision_lang_torch.ops import fused_block as fb
    from debias_vision_lang_torch.ops import fused_block_q as fbq
    from debias_vision_lang_torch.utils.fingerprint import (image_tower_tensors,
                                                           params_fingerprint)
    from debias_vision_lang_torch.vision.preprocess import Preprocess

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    try:
        root = os.path.join(tmp, "fairface")
        t0 = time.perf_counter()
        write_fairface(root, 0, CACHE_VAL)
        print(f"synthetic FairFace val ({CACHE_VAL} images at 224 px) written in "
              f"{time.perf_counter() - t0:.2f} s")
        n_batches = -(-CACHE_VAL // BATCH)
        preproc = Preprocess(n_px=model.clip_cfg.vision.image_size)
        seen = []  # (labels, image embeddings) as each call ranks them
        ranking = M.eval_ranking

        def recording_ranking(labels, img_embs, *args, **kw):
            seen.append((labels, img_embs))
            return ranking(labels, img_embs, *args, **kw)

        def call(m, dtype, cache, evaluation, topn):
            """One measure_bias call, counters at 0 just before and read just
            after: (metrics, launches, wall s, what it ranked)."""
            opts = {"dtype": dtype, "data_path": root, "evaluations": (evaluation,),
                    "topn": topn}
            if cache:
                opts["cache_embeddings"] = cache
            seen.clear()
            torch.cuda.synchronize()
            reset_all(fb, fbq, A)
            t0 = time.perf_counter()
            out = M.measure_bias(m, preproc, tokenizer, "gender", opts=opts)[evaluation]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            return out, launches_of(fb, fbq, A), wall, seen[0]

        # the image tower's digest, on the card and on a CPU copy
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        digest = params_fingerprint(image_tower_tensors(model))
        fp_s = time.perf_counter() - t0  # the first call in the process
        t0 = time.perf_counter()
        check(params_fingerprint(image_tower_tensors(model)) == digest,
              "the fingerprint changed between two calls")
        fp2_s = time.perf_counter() - t0
        cpu_digest = params_fingerprint({k: v.cpu() for k, v in
                                         image_tower_tensors(model).items()})
        print(f"image tower fingerprint {digest[:16]}... in {fp_s * 1e3:.2f} ms on the "
              f"card (a second call {fp2_s * 1e3:.2f} ms); CPU copy "
              f"{'equal' if cpu_digest == digest else 'DIFFERS'}")
        check(cpu_digest == digest, "the fingerprint differs between the card and the CPU")

        M.eval_ranking = recording_ranking
        try:
            bf16_file = os.path.join(tmp, "val_bf16.npz")
            int8_file = os.path.join(tmp, "val_int8.npz")
            uncached, counts, unc_s, _ = call(model, "bfloat16", None, "maxskew", 0.1)
            print(f"cache: uncached bf16 MaxSkew@0.1 {uncached} in {unc_s:.3f} s "
                  f"({decode}); launches {counts}")
            ndkl, counts, miss_s, written = call(model, "bfloat16", bf16_file, "ndkl", 1.0)
            print(f"cache: bf16 miss, NDKL@1.0 {ndkl} in {miss_s:.3f} s ({decode}); "
                  f"launches {counts}")
            want = {k: 0 for k in counts}
            want.update(attention_block=LAYERS * n_batches, mlp_block=LAYERS * n_batches)
            check(counts == want, f"the bf16 miss launched {counts}, expected {want}")
            check(all(math.isfinite(v) for v in ndkl.values()), "non-finite NDKL")
            _, counts, q_miss_s, _ = call(model, "int8", int8_file, "ndkl", 1.0)
            want = {k: 0 for k in counts}
            want.update(attention_block_q=LAYERS * n_batches, mlp_block_q=LAYERS * n_batches)
            print(f"cache: int8 miss in {q_miss_s:.3f} s; launches {counts}")
            check(counts == want, f"the int8 miss launched {counts}, expected {want}")

            shutil.rmtree(os.path.join(root, "imgs"))  # a hit reads no image file
            hit, counts, hit_s, read = call(model, "bfloat16", bf16_file, "maxskew", 0.1)
            print(f"cache: bf16 hit (val images deleted), MaxSkew@0.1 {hit} in "
                  f"{hit_s:.3f} s; launches {counts}")
            check(sum(counts.values()) == 0, f"the hit launched kernels: {counts}")
            check(np.array_equal(read[0], written[0])
                  and torch.equal(read[1], written[1]),
                  "the hit's labels or embeddings differ from those the miss wrote")
            for k, v in hit.items():
                check(abs(v - uncached[k]) <= METRIC_ATOL,
                      f"cache hit MaxSkew {k}: {v} vs uncached {uncached[k]}")
            print(f"cache: the hit read back the miss's {tuple(read[1].shape)} embeddings "
                  f"and labels bit for bit; its metrics equal the uncached call's within "
                  f"{METRIC_ATOL}")
            _, counts, _, _ = call(model, "int8", int8_file, "maxskew", 0.1)
            print(f"cache: int8 hit; launches {counts}")
            check(sum(counts.values()) == 0, f"the int8 hit launched kernels: {counts}")

            try:
                call(model, "int8", bf16_file, "maxskew", 0.1)
                check(False, "an int8 call read the bf16 cache")
            except ValueError as e:
                print(f"cache: an int8 call on the bf16 file raises: {str(e)[:60]}...")

            other = copy.deepcopy(model)
            with torch.no_grad():
                other.debias_tokens.add_(1.0)
            _, counts, _, _ = call(other, "bfloat16", bf16_file, "maxskew", 0.1)
            print(f"cache: other debias tokens hit; launches {counts}")
            check(sum(counts.values()) == 0, "other debias tokens missed the cache")
            with torch.no_grad():
                w = other.clip.visual.resblocks[0].attn.wqkv.view(-1)
                w[0] = torch.nextafter(w[0], torch.tensor(math.inf, device=w.device))
            try:
                call(other, "bfloat16", bf16_file, "maxskew", 0.1)
                check(False, "a vision weight one ulp away read the cache")
            except ValueError as e:
                print(f"cache: one vision weight one float32 ulp away raises the key "
                      f"mismatch: {str(e)[:60]}...")
            del other
        finally:
            M.eval_ranking = ranking
        print(f"cache wall times (host clock; {card}): fingerprint {fp_s * 1e3:.2f} ms "
              f"(first call; a second {fp2_s * 1e3:.2f} ms), "
              f"miss {miss_s:.3f} s, hit {hit_s:.3f} s, uncached {unc_s:.3f} s "
              f"({CACHE_VAL} images + 319 prompts, bf16; miss and uncached {decode})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def update_cosine(start, a, b):
    """Cosine of the two updates a - start and b - start over every entry
    of three state dicts on the CPU, and the largest |a - b|."""
    import torch

    da = torch.cat([(a[k] - v).double().reshape(-1) for k, v in start.items()])
    db = torch.cat([(b[k] - v).double().reshape(-1) for k, v in start.items()])
    cos = (da @ db / (da.norm() * db.norm())).item()
    return cos, (da - db).abs().max().item()


def pretrain_witness(E, world, seed, card):
    """Phase 15's first witness: the seed's pretraining on the card against
    the same calls on the CPU, from the same init and batches.  The step-0
    loss and every gradient tensor within GRAD0_RTOL of its largest
    magnitude (at least 1.0); after 3 Adam steps the loss
    within STEP3_ATOL and the update's cosine at least STEP3_UPDATE_COS;
    after 20 steps the same, reported."""
    import torch
    from debias_vision_lang_torch.models.clip import CLIP

    imgs, caps = world["train_images"], world["train_captions"]
    init, cfg = E.pretrain_tiny_clip(imgs, caps, steps=0, seed=seed, device="cpu")
    sel = np.random.default_rng(seed).permutation(len(imgs))[:64]  # step 0's batch
    batch = torch.from_numpy(np.ascontiguousarray(imgs[sel]))
    toks = torch.from_numpy(E.word_tokenize([caps[i] for i in sel])).long()

    def loss_grads(params, dev, grads=True):
        m = CLIP(cfg)
        m.load_state_dict(params)
        m.to(dev)
        with torch.set_grad_enabled(grads):
            loss = E.pretrain_loss(m, batch.to(dev), toks.to(dev), cfg)
        if not grads:
            return loss.item()
        loss.backward()
        return loss.item(), {n: p.grad.cpu() for n, p in m.named_parameters()}

    (l_card, g_card), (l_cpu, g_cpu) = loss_grads(init, "cuda"), loss_grads(init, "cpu")
    # each gradient tensor's largest difference over its bar, 1e-5 of its
    # largest magnitude (at least 1e-5)
    share, worst = max(((g_card[n] - g).abs().max().item()
                        / (GRAD0_RTOL * max(1.0, g.abs().max().item())), n)
                       for n, g in g_cpu.items())
    g = g_cpu[worst]
    print(f"ablation seed {seed}: pretraining step 0 on the card vs the CPU: loss "
          f"{l_card:.7f} vs {l_cpu:.7f}; gradients: the largest difference over its bar "
          f"{share:.3f}, in {worst} ({(g_card[worst] - g).abs().max().item():.2e}, its "
          f"largest |gradient| {g.abs().max().item():.3g}; bar {GRAD0_RTOL} of "
          f"max(1, that))")
    check(abs(l_card - l_cpu) <= GRAD0_RTOL * max(1.0, abs(l_cpu)) and share <= 1.0,
          f"seed {seed}: the step-0 pretraining loss or gradients differ on the card")
    for steps in (3, 20):
        card_p, _ = E.pretrain_tiny_clip(imgs, caps, steps=steps, seed=seed, device="cuda")
        cpu_p, _ = E.pretrain_tiny_clip(imgs, caps, steps=steps, seed=seed, device="cpu")
        card_p = {k: v.cpu() for k, v in card_p.items()}
        cos, d_param = update_cosine(init, card_p, cpu_p)
        d_loss = abs(loss_grads(card_p, "cpu", False) - loss_grads(cpu_p, "cpu", False))
        print(f"ablation seed {seed}: pretraining after {steps} steps, card vs CPU: loss on "
              f"step 0's batch {d_loss:.2e} apart, update cosine {cos:.7f}, largest "
              f"parameter difference {d_param:.2e}"
              + (f" (bars: loss {STEP3_ATOL}, cosine {STEP3_UPDATE_COS})"
                 if steps == 3 else " (reported)"))
        if steps == 3:
            check(d_loss <= STEP3_ATOL and cos >= STEP3_UPDATE_COS,
                  f"seed {seed}: 3 pretraining steps on the card part from the CPU's")


def arms_witness(E, world, params, cfg, seed, card_arms, root, card):
    """Phase 15's second witness: both arms of the valid seed again, on the
    CPU, from the tower the card pretrained: the before, the after and
    every eval of the NDKL curve within ARM_ATOL of the card's, the probe
    accuracy within PROBE_ATOL.  Returns {arm: NDKL drop on the CPU}."""
    from debias_vision_lang_torch.data.datasets import FairFace

    val = FairFace(mode="val", iat_type="gender", data_path=world["fairface"],
                   download=False)
    tower = {k: v.cpu() for k, v in params.items()}
    drops = {}
    for name, w in (("adversarial", 1.0), ("control", 0.0)):
        t0 = time.perf_counter()
        rec = E.run_arm(world, tower, cfg, val, os.path.join(root, f"cpu_{name}"),
                        seed=seed, adversarial_weight=w, device="cpu")
        wall = time.perf_counter() - t0
        ref = card_arms[name]
        check([c["step"] for c in rec["curve"]] == [c["step"] for c in ref["curve"]],
              f"{name}: the CPU replay evaluated at other steps")
        d_curve = max(abs(a["ndkl_eq_opp"] - b["ndkl_eq_opp"])
                      for a, b in zip(rec["curve"], ref["curve"]))
        d_metric = max(abs(rec[p][k] - v) for p in ("before", "after")
                       for k, v in ref[p].items() if k != "probe_acc")
        d_probe = max(abs(rec[p]["probe_acc"] - ref[p]["probe_acc"])
                      for p in ("before", "after"))
        drops[name] = rec["reduction"]["ndkl_eq_opp"]
        print(f"ablation seed {seed} {name}: the CPU replay from the card's tower: curve "
              f"{[round(c['ndkl_eq_opp'], 6) for c in rec['curve']]}; largest difference "
              f"from the card's: curve {d_curve:.2e}, before/after metrics {d_metric:.2e}, "
              f"probe {d_probe:.2e} (bars {ARM_ATOL}, probe {PROBE_ATOL}); NDKL drop "
              f"{drops[name]:.4f} (card {ref['reduction']['ndkl_eq_opp']:.4f}); "
              f"{wall:.1f} s on the CPU")
        check(d_curve <= ARM_ATOL and d_metric <= ARM_ATOL and d_probe <= PROBE_ATOL,
              f"{name}: the card's arm parts from the CPU's from one tower")
    return drops


def ablation_phase(card):
    """Phase 15: the adversary ablation (train/efficacy.py) at the JAX
    module's defaults on the card, seed 0 first; a seed whose world fails
    the harness's preconditions is printed as invalid and the next one
    runs (up to seed 2).  Every seed that ran is held to the CPU's
    pretraining, and the valid one's arms to the CPU's from the card's
    tower.  Returns the ablation's wall time (s)."""
    import shutil

    import torch
    from debias_vision_lang_torch.ops import attention as A
    from debias_vision_lang_torch.ops import fused_block as fb
    from debias_vision_lang_torch.ops import fused_block_q as fbq
    from debias_vision_lang_torch.train import efficacy as E

    stages = []  # (stage, wall s), in call order
    last = {}  # stage -> its last result: the seed's world and tower
    originals = {n: getattr(E, n) for n in ("build_world", "pretrain_tiny_clip",
                                            "measure_model", "run_arm")}

    def timed(name, fn):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            stages.append((name, time.perf_counter() - t0))
            last[name] = out
            return out
        return wrapper

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ablation_")
    t_all = time.perf_counter()
    ran, valid = {}, None  # seed -> (world, tower, cfg); (seed, arms)
    try:
        for n, fn in originals.items():
            setattr(E, n, timed(n, fn))
        for seed in ABLATION_SEEDS:
            stages.clear()
            reset_all(fb, fbq, A)
            res = E.run_ablation_experiment(tmp, seeds=(seed,), device="cuda")
            counts = launches_of(fb, fbq, A)
            ran[seed] = (last["build_world"], *last["pretrain_tiny_clip"])
            print(f"ablation seed {seed}: stage wall times (s, host clock; {card}): "
                  + ", ".join(f"{n} {t:.2f}" for n, t in stages)
                  + f"; launches {counts}")
            check(sum(counts.values()) == 0,
                  f"the width-64 efficacy world launched kernels: {counts}")
            if seed in res["invalid"]:
                print(f"ablation seed {seed}: INVALID world, fails "
                      f"{res['invalid'][seed]['failed']}; before "
                      f"{json.dumps(res['invalid'][seed]['before'])}")
                continue
            valid = (seed, res["seeds"][seed])
            break
    finally:
        for n, fn in originals.items():
            setattr(E, n, fn)
    abl_s = time.perf_counter() - t_all
    try:
        check(valid is not None, f"no valid efficacy world among seeds {ABLATION_SEEDS}")
        seed, arms = valid
        for name, rec in arms.items():
            print(f"ablation seed {seed} {name}: before {json.dumps(rec['before'])}; after "
                  f"{json.dumps(rec['after'])}; reduction {json.dumps(rec['reduction'])}; "
                  f"curve {[round(c['ndkl_eq_opp'], 6) for c in rec['curve']]}")
            values = [v for part in ("before", "after", "reduction") for v in rec[part].values()]
            check(all(math.isfinite(v) for v in values), f"{name}: non-finite metrics")
            export = torch.load(rec["train_summary"]["export"], map_location="cpu",
                                weights_only=True)
            check(type(export) is torch.Tensor and tuple(export.shape) == (2, 64),
                  f"{name}: the .pt export is not a [2, 64] tensor")
            check(len(rec["curve"]) >= 3, f"{name}: {len(rec['curve'])} curve points")
        adv, ctl = arms["adversarial"], arms["control"]
        check(adv["before"] == ctl["before"], "the two arms start from different models")
        adv_drop = adv["reduction"]["ndkl_eq_opp"]
        ctl_drop = ctl["reduction"]["ndkl_eq_opp"]
        print(f"ablation seed {seed}: NDKL drop adversarial {adv_drop:.4f}, control "
              f"{ctl_drop:.4f}; the adversarial arm beats the control "
              f"{adv_drop > ctl_drop}; JAX's stricter bars: adversarial >= 0.40 "
              f"{adv_drop >= 0.40}, gap >= 0.25 {adv_drop - ctl_drop >= 0.25}, probe within "
              f"0.15 {adv['after']['probe_acc'] >= adv['before']['probe_acc'] - 0.15} "
              f"(findings, not gates); ablation wall {abl_s:.1f} s ({card})")

        # the witnesses: the card against the CPU from one start
        t0 = time.perf_counter()
        for s, (world, _, _) in ran.items():
            pretrain_witness(E, world, s, card)
        world, tower, cfg = ran[seed]
        cpu_drops = arms_witness(E, world, tower, cfg, seed, arms, tmp, card)
        print(f"ablation seed {seed}: from the card's tower the CPU's arms drop NDKL by "
              f"{cpu_drops['adversarial']:.4f} (adversarial) and {cpu_drops['control']:.4f} "
              f"(control): the adversarial arm beats the control "
              f"{cpu_drops['adversarial'] > cpu_drops['control']} on the CPU, "
              f"{adv_drop > ctl_drop} on the card; witnesses {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return abl_s


SERVE_MAX_BATCH = 64
SERVE_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
SERVE_CLIENTS = 32  # concurrent single-image clients: the batcher must coalesce them
SERVE_LATENCY_N = 50  # sequential single-item requests per modality (p50 / p99)
SERVE_THROUGHPUT = (256, 8)  # frames per raw u8 request, requests


def http(base, path, body=None, headers=None):
    """(status, headers, body) of one request; an HTTP error is a status."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, data=body, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def png_bytes(rng, h, w):
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def jpeg_bytes(rng, h, w):
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
        buf, format="JPEG", quality=92)
    return buf.getvalue()


class ServeRecorder:
    """Wraps an engine's dispatch and fetch: counts and times every dispatch
    (host staging + launch) and fetch (device wait + copy), and, while
    ``keep`` is set, keeps each dispatch's items and result on the card for
    the row check."""

    def __init__(self, engine):
        import threading

        self.engine = engine
        self.keep = True
        self.lock = threading.Lock()
        self.dispatches = {"image": [], "text": []}  # (items, handle) while keep
        self.counts = {"image": 0, "text": 0}
        self.buckets = {"image": [], "text": []}
        self.dispatch_s, self.fetch_s = [], []
        for kind, name in (("image", "dispatch_image_arrays"), ("text", "dispatch_token_arrays")):
            setattr(engine, name, self._dispatch(kind, getattr(engine, name)))
        fetch = engine.fetch

        def timed_fetch(handle, n):
            t0 = time.perf_counter()
            out = fetch(handle, n)
            with self.lock:
                self.fetch_s.append((handle.shape[0], time.perf_counter() - t0))
            return out

        engine.fetch = timed_fetch

    def _dispatch(self, kind, orig):
        def dispatch(items):
            t0 = time.perf_counter()
            handle = orig(items)
            dt = time.perf_counter() - t0
            with self.lock:
                self.counts[kind] += 1
                self.buckets[kind].append(handle.shape[0])
                self.dispatch_s.append((handle.shape[0], dt))
                if self.keep:
                    self.dispatches[kind].append(([np.array(i) for i in items], handle))
            return handle

        return dispatch


def staged_image(engine, item):
    from debias_vision_lang_torch.vision.preprocess import patchify_u8

    return item if item.ndim == 2 else patchify_u8(item, engine._patch)


def check_served_rows(tag, engine, rec, served):
    """Every kept dispatch against a direct encode_image / encode_text call on
    the same staged bucket (one bf16 ulp of the row's largest magnitude; bit
    equality expected), and every row a client received (``served``: staged
    input bytes -> received row) against the row the engine computed for
    that input.  Returns {kind: (staged inputs [N, ...], engine rows [N, D])}."""
    import torch

    model, dt = engine.model, engine.compute_dtype
    out, worst, n_bit = {}, 0.0, 0
    for kind, dispatches in rec.dispatches.items():
        inputs, rows = [], []
        for items, handle in dispatches:
            b, n = handle.shape[0], len(items)
            if kind == "image":
                staged = np.zeros((b, *staged_image(engine, items[0]).shape), np.uint8)
                staged[:n] = [staged_image(engine, i) for i in items]
            else:
                staged = np.zeros((b, engine.context_length), np.int64)
                staged[:n] = items
            x = torch.from_numpy(staged).to(handle.device)
            with torch.inference_mode():
                direct = (model.encode_image(x, dtype=dt) if kind == "image"
                          else model.encode_text(x, dtype=dt)).float()
            got, want = handle[:n], direct[:n]
            diff = (got - want).abs()
            ulp = torch.exp2(torch.floor(torch.log2(want.abs().amax(-1, keepdim=True))) - 7)
            worst = max(worst, (diff / ulp).max().item())
            n_bit += int(torch.equal(got, want))
            check(bool((diff <= ulp).all()),
                  f"{tag}: a served {kind} row differs from the direct call on the same "
                  f"staged bucket of {b} by {diff.max().item()} (> one bf16 ulp)")
            inputs.extend(staged[:n])
            rows.append(got)
        out[kind] = (np.stack(inputs), torch.cat(rows))
    print(f"{tag}: {sum(len(d) for d in rec.dispatches.values())} dispatches held to the direct "
          f"call on the same staged bucket: {n_bit} bit-identical, largest difference "
          f"{worst:.3f} bf16 ulp of its row's largest magnitude (bar 1)")
    index = {kind: {inp.tobytes(): i for i, inp in enumerate(inputs)}
             for kind, (inputs, _) in out.items()}
    n_rows = 0
    for kind, pairs in served.items():
        rows = out[kind][1].cpu().numpy()
        for key, row in pairs:
            check(key in index[kind], f"{tag}: a served {kind} row has no dispatch")
            check(np.array_equal(rows[index[kind][key]], row),
                  f"{tag}: the {kind} row a client received is not the engine's")
            n_rows += 1
    print(f"{tag}: {n_rows} rows received over HTTP, each the engine's own row bit for bit")
    return out


def cosine_vs_float32(tag, engine, base_model, rows):
    """Per-row cosine of the served rows against the float32 plain path."""
    import torch

    device = engine.device
    for kind, (inputs, got) in rows.items():
        refs = []
        with torch.no_grad():
            for i in range(0, len(inputs), 64):
                x = torch.from_numpy(inputs[i:i + 64]).to(device)
                refs.append((base_model.encode_image(x, dtype=torch.float32) if kind == "image"
                             else base_model.encode_text(x)).float())
        cosine_check(f"{tag} {kind} embeddings ({len(inputs)}) vs float32 plain path",
                     got, torch.cat(refs))


def dispatch_split(engine, batch, iters=10):
    """ms of one image dispatch of ``batch``: the whole dispatch (staging
    into pinned memory, the copy's enqueue, the launches; host clock), the
    tower's launches alone on a tensor already on the card (host clock),
    and the tower on the card (CUDA events)."""
    import torch
    from debias_vision_lang_torch.serve.engine import _embed_images_u8

    x = torch.from_numpy(np.stack([staged_image(engine, f) for f in batch])).to(engine.device)
    out = {"dispatch": [], "launch": [], "device": []}
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.dispatch_image_arrays(list(batch))
        out["dispatch"].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        t0 = time.perf_counter()
        _embed_images_u8(engine.model, x, engine.compute_dtype)
        out["launch"].append((time.perf_counter() - t0) * 1e3)
        e1.record()
        torch.cuda.synchronize()
        out["device"].append(e0.elapsed_time(e1))
    return out


def serve_phase(model, tokenizer, prompts, card, tower_img_s):
    """Phase 16: the port's serving path (serve/engine.py, batcher, HTTP
    server) on the phase-4 model, bfloat16 then int8."""
    import base64
    import threading

    import torch
    from debias_vision_lang_torch import native
    from debias_vision_lang_torch.ops import attention as A
    from debias_vision_lang_torch.ops import fused_block as fb
    from debias_vision_lang_torch.ops import fused_block_q as fbq
    from debias_vision_lang_torch.serve import (InferenceEngine, ServeApp, decode_image_bytes,
                                                make_server)
    from debias_vision_lang_torch.vision.preprocess import resize_crop_u8

    device = next(model.parameters()).device
    n_px = model.clip_cfg.vision.image_size
    rng = np.random.default_rng(16)
    raw = {"Content-Type": "application/octet-stream", "X-Image-Format": "u8"}
    js = {"Content-Type": "application/json"}

    def frames(n):
        return rng.integers(0, 256, (n, n_px, n_px, 3), dtype=np.uint8)

    def expect(status, want, what, body=b""):
        check(status == want, f"phase 16 {what}: HTTP {status}, expected {want}: "
                              f"{body[:300]!r}")

    def start(engine):
        t0 = time.perf_counter()
        stamps = []
        engine.warmup(log=lambda m: stamps.append((m, time.perf_counter())))
        torch.cuda.synchronize()
        stamps.append(("end", time.perf_counter()))
        per = [f"{m.split()[-1]}: {(t1 - t) * 1e3:.1f}"
               for (m, t), (_, t1) in zip(stamps, stamps[1:])]
        print(f"serve {engine.precision}: warmup of {len(per)} buckets x 2 towers in "
              f"{time.perf_counter() - t0:.2f} s; ms per bucket {', '.join(per)} ({card})")
        rec = ServeRecorder(engine)
        app = ServeApp(engine, max_wait_ms=5.0)
        httpd = make_server(app, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        return rec, app, httpd, thread, f"http://127.0.0.1:{httpd.server_address[1]}"

    def stop(app, httpd, thread):
        httpd.shutdown()
        httpd.server_close()
        app.close()
        thread.join(timeout=10)
        check(not thread.is_alive(), "phase 16: the server thread did not stop")

    def embed_u8(base, batch, served):
        status, h, body = http(base, "/v1/embed/image-raw", batch.tobytes(), raw)
        expect(status, 200, f"image-raw u8 x{len(batch)}", body)
        rows = np.frombuffer(body, "<f4").reshape(int(h["X-Count"]), int(h["X-Dim"]))
        check(rows.shape[0] == len(batch) and np.isfinite(rows).all(), "image-raw u8 rows")
        if served is not None:
            served["image"] += [(staged_image(engine, f).tobytes(), r) for f, r in zip(batch, rows)]
        return rows

    def embed_text(base, texts, served):
        status, _, body = http(base, "/v1/embed/text",
                               json.dumps({"texts": list(texts)}).encode(), js)
        expect(status, 200, f"text x{len(texts)}", body)
        rows = np.asarray(json.loads(body)["embeddings"], np.float32)
        check(rows.shape[0] == len(texts) and np.isfinite(rows).all(), "text rows")
        if served is not None:
            toks = engine.tokenize(list(texts))
            served["text"] += [(t.tobytes(), r) for t, r in zip(toks, rows)]
        return rows

    counters = (fb, fbq, A)
    # -- bfloat16 ----------------------------------------------------------
    engine = InferenceEngine(model, tokenizer, max_batch=SERVE_MAX_BATCH,
                             compute_dtype="bfloat16", device=device)
    check(engine._patch == 16, "phase 16: the bf16 engine does not stage patch-contiguous")
    rec, app, httpd, thread, base = start(engine)
    served = {"image": [], "text": []}
    try:
        torch.cuda.synchronize()
        reset_all(*counters)
        status, _, body = http(base, "/healthz")
        expect(status, 200, "healthz", body)
        info = json.loads(body)
        print(f"healthz: backend {info['backend']}, device {info['device_name']}, "
              f"precision {info['precision']}, device memory {info['device_memory']}")
        check(info["backend"] == "cuda" and info["device_name"] == torch.cuda.get_device_name(0),
              "phase 16: /healthz does not name the card")

        pngs = [png_bytes(rng, 240 + 16 * i, 320 - 8 * i) for i in range(4)]
        status, _, body = http(base, "/v1/embed/image", json.dumps(
            {"images_b64": [base64.b64encode(p).decode() for p in pngs]}).encode(), js)
        expect(status, 200, "embed/image x4 PNG", body)
        rows = np.asarray(json.loads(body)["embeddings"], np.float32)
        served["image"] += [(staged_image(engine, engine.prepare_image(p)).tobytes(), r)
                            for p, r in zip(pngs, rows)]

        embed_u8(base, frames(100), served)

        jpegs = [jpeg_bytes(rng, 200 + 24 * i, 260) for i in range(8)]
        stream = b"".join(len(j).to_bytes(4, "big") + j for j in jpegs)
        t0 = time.perf_counter()
        status, h, body = http(base, "/v1/embed/image-raw", stream,
                               {**raw, "X-Image-Format": "jpeg"})
        jpeg_ms = (time.perf_counter() - t0) * 1e3
        expect(status, 200, "image-raw jpeg x8", body)
        rows = np.frombuffer(body, "<f4").reshape(8, -1)
        served["image"] += [(staged_image(engine, p).tobytes(), r)
                            for p, r in zip(engine.prepare_images_batch(jpegs), rows)]
        print(f"image-raw jpeg x8: {jpeg_ms:.1f} ms, decoded by "
              f"{'the native ingest' if native.available() else 'PIL (no native ingest)'} "
              f"({card})")

        embed_text(base, prompts, served)

        png = png_bytes(rng, 224, 224)
        texts = [f"a photo of a {w} person" for w in
                 ("happy", "sad", "tall", "short", "young", "old", "kind", "rude")]
        status, _, body = http(base, "/v1/score", json.dumps(
            {"image_b64": base64.b64encode(png).decode(), "texts": texts}).encode(), js)
        expect(status, 200, "score", body)
        probs = np.asarray(json.loads(body)["probs"])
        check(probs.shape == (8,) and abs(probs.sum() - 1.0) <= 1e-5,
              f"phase 16: probs sum to {probs.sum()}")

        before = dict(app._images.stats)
        burst = frames(SERVE_CLIENTS)
        results = [None] * SERVE_CLIENTS
        barrier = threading.Barrier(SERVE_CLIENTS)

        def client(i):
            barrier.wait()
            results[i] = http(base, "/v1/embed/image-raw", burst[i].tobytes(), raw)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        burst_s = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "phase 16: a client hung")
        for i, (status, h, body) in enumerate(results):
            expect(status, 200, f"concurrent client {i}", body)
            served["image"].append((staged_image(engine, burst[i]).tobytes(),
                                    np.frombuffer(body, "<f4")))
        after = app._images.stats
        n_b, n_i = after["batches"] - before["batches"], after["items"] - before["items"]
        print(f"{SERVE_CLIENTS} concurrent single-image clients: {n_i} items in {n_b} "
              f"dispatches ({n_i / n_b:.1f} per dispatch), {burst_s * 1e3:.1f} ms, "
              f"{SERVE_CLIENTS / burst_s:.1f} img/s coalesced ({card})")
        check(n_i == SERVE_CLIENTS and n_b < SERVE_CLIENTS,
              f"phase 16: the batcher did not coalesce ({n_b} dispatches for {n_i} requests)")

        status, _, body = http(base, "/v1/embed/image", json.dumps(
            {"images_b64": [base64.b64encode(b"notanimage").decode()]}).encode(), js)
        expect(status, 400, "undecodable image", body)
        embed_u8(base, frames(1), served)

        for b in SERVE_BUCKETS:
            embed_u8(base, frames(b), served)
            embed_text(base, [f"bucket {b} prompt {i}" for i in range(b)], served)
            toks = engine.tokenize([f"direct bucket {b} prompt {i}" for i in range(b)])
            engine.embed_token_arrays(list(toks))
        img_buckets = set(rec.buckets["image"])
        print(f"image buckets dispatched: {sorted(img_buckets)}; text buckets dispatched: "
              f"{sorted(set(rec.buckets['text']))}")
        check(set(SERVE_BUCKETS) <= img_buckets and set(SERVE_BUCKETS) <= set(rec.buckets["text"]),
              "phase 16: a bucket of 1-64 was not served")

        # print, not gate: latency, throughput, dispatch against fetch
        rec.keep = False
        lat = {"image": [], "text": []}
        for i in range(SERVE_LATENCY_N):
            one = frames(1)
            t0 = time.perf_counter()
            embed_u8(base, one, None)
            lat["image"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            embed_text(base, [f"latency prompt number {i}"], None)
            lat["text"].append(time.perf_counter() - t0)
        for kind, ts in lat.items():
            ms = np.asarray(ts) * 1e3
            print(f"serve bf16 {kind} latency, {SERVE_LATENCY_N} sequential single-item "
                  f"requests: p50 {np.percentile(ms, 50):.2f} ms, p99 "
                  f"{np.percentile(ms, 99):.2f} ms (host clock, HTTP on localhost; {card})")
        n_fr, n_req = SERVE_THROUGHPUT
        bodies = [frames(n_fr) for _ in range(n_req)]
        embed_u8(base, bodies[0], None)  # one unmeasured request first
        rec.dispatch_s.clear()
        rec.fetch_s.clear()
        t0 = time.perf_counter()
        for batch in bodies:
            embed_u8(base, batch, None)
        e2e = n_fr * n_req / (time.perf_counter() - t0)
        print(f"serve bf16 end to end: {n_req} requests of {n_fr} raw u8 frames, "
              f"{e2e:.1f} img/s through HTTP, against {tower_img_s:.1f} img/s of the bf16 "
              f"tower alone at B=256 (phase 13) ({card})")
        d_ms = np.asarray([t for _, t in rec.dispatch_s]) * 1e3
        f_ms = np.asarray([t for _, t in rec.fetch_s]) * 1e3
        print(f"serve bf16 per dispatch of 64 frames ({len(d_ms)} dispatches): host staging + "
              f"launch median {np.median(d_ms):.2f} ms (max {d_ms.max():.2f}), fetch (device "
              f"wait + copy) median {np.median(f_ms):.2f} ms (max {f_ms.max():.2f}); batcher "
              f"totals: image dispatch {app._images.run_seconds:.3f} s, finalize "
              f"{app._images.finalize_seconds:.3f} s ({card})")

        torch.cuda.synchronize()
        launches = launches_of(*counters)
        n_img, n_txt = rec.counts["image"], rec.counts["text"]
        want = {k: 0 for k in launches}
        want.update({"attention_block": LAYERS * n_img, "attention_block_causal": LAYERS * n_txt,
                     "mlp_block": LAYERS * (n_img + n_txt)})
        print(f"serve bf16: {n_img} image and {n_txt} text dispatches; launches {launches}")
        check(launches == want, f"phase 16 bf16 launches {launches}, expected {want}")
        # after the count: these launches are the measurement's, not the path's
        split = dispatch_split(engine, frames(SERVE_MAX_BATCH))
        print(f"serve bf16 one 64-frame dispatch, median of {len(split['dispatch'])}: "
              f"dispatch {np.median(split['dispatch']):.2f} ms host, of it the tower's "
              f"launches {np.median(split['launch']):.2f} ms host and staging + copy the "
              f"rest; the tower on the card {np.median(split['device']):.2f} ms (CUDA "
              f"events) ({card})")
        t0 = time.perf_counter()
        decoded = decode_image_bytes(jpegs[0])
        t1 = time.perf_counter()
        resize_crop_u8(decoded, n_px)
        t2 = time.perf_counter()
        how = "native ingest" if native.available() else "PIL decode, numpy resize"
        print(f"host decode of one {decoded.shape[1]}x{decoded.shape[0]} JPEG: "
              f"decode_image_bytes {(t1 - t0) * 1e3:.2f} ms, resize_crop_u8 "
              f"{(t2 - t1) * 1e3:.2f} ms ({how}; {card})")
        rows = check_served_rows("serve bf16", engine, rec, served)
        cosine_vs_float32("serve bf16", engine, model, rows)
    finally:
        stop(app, httpd, thread)

    # -- int8 --------------------------------------------------------------
    engine = InferenceEngine(model, tokenizer, max_batch=SERVE_MAX_BATCH, compute_dtype="int8",
                             device=device)
    rec, app, httpd, thread, base = start(engine)
    served = {"image": [], "text": []}
    try:
        torch.cuda.synchronize()
        reset_all(*counters)
        embed_u8(base, frames(100), served)
        embed_text(base, prompts[:64], served)
        torch.cuda.synchronize()
        launches = launches_of(*counters)
        n_img, n_txt = rec.counts["image"], rec.counts["text"]
        want = {k: 0 for k in launches}
        want.update({"attention_block_q": LAYERS * n_img, "mlp_block_q": LAYERS * n_img,
                     "attention_block_causal": LAYERS * n_txt, "mlp_block": LAYERS * n_txt})
        print(f"serve int8: {n_img} image and {n_txt} text dispatches; launches {launches}")
        check(launches == want, f"phase 16 int8 launches {launches}, expected {want}")
        rows = check_served_rows("serve int8", engine, rec, served)
        cosine_vs_float32("serve int8", engine, model, rows)
    finally:
        stop(app, httpd, thread)


# the port's residual-block parameter names -> OpenAI CLIP's and timm's
# (SLIP's image tower); True where a torch Linear weight ([out, in]) is the
# transpose of ours
BLOCK_NAMES = {"ln_1.scale": ("ln_1.weight", "norm1.weight", False),
               "ln_1.bias": ("ln_1.bias", "norm1.bias", False),
               "attn.wqkv": ("attn.in_proj_weight", "attn.qkv.weight", True),
               "attn.bqkv": ("attn.in_proj_bias", "attn.qkv.bias", False),
               "attn.wo": ("attn.out_proj.weight", "attn.proj.weight", True),
               "attn.bo": ("attn.out_proj.bias", "attn.proj.bias", False),
               "ln_2.scale": ("ln_2.weight", "norm2.weight", False),
               "ln_2.bias": ("ln_2.bias", "norm2.bias", False),
               "mlp.w1": ("mlp.c_fc.weight", "mlp.fc1.weight", True),
               "mlp.b1": ("mlp.c_fc.bias", "mlp.fc1.bias", False),
               "mlp.w2": ("mlp.c_proj.weight", "mlp.fc2.weight", True),
               "mlp.b2": ("mlp.c_proj.bias", "mlp.fc2.bias", False)}
OPENAI_NAMES = {"visual.ln_pre.scale": "visual.ln_pre.weight",
                "visual.ln_post.scale": "visual.ln_post.weight",
                "text.token_embedding": "token_embedding.weight",
                "text.positional_embedding": "positional_embedding",
                "text.ln_final.scale": "ln_final.weight", "text.ln_final.bias": "ln_final.bias",
                "text.text_projection": "text_projection"}


def patch_conv(kernel, patch):
    """The port's [p*p*3, width] patch kernel -> a [width, 3, p, p] conv."""
    return kernel.reshape(patch, patch, 3, -1).permute(3, 2, 0, 1).contiguous()


def openai_state_dict(sd, patch, timm_prefix=None):
    """The port's CLIP state dict in OpenAI CLIP naming (the inverse of
    ``params_from_openai_state_dict``); with ``timm_prefix`` the image
    blocks take timm's names under that prefix instead (SLIP's)."""
    out = {}
    for k, v in sd.items():
        m = re.match(r"(visual|text)\.resblocks\.(\d+)\.(.+)$", k)
        if m:
            oa, timm, t = BLOCK_NAMES[m.group(3)]
            if m.group(1) == "visual" and timm_prefix:
                out[f"{timm_prefix}.{m.group(2)}.{timm}"] = v.T.contiguous() if t else v
            else:
                tower = "visual.transformer" if m.group(1) == "visual" else "transformer"
                out[f"{tower}.resblocks.{m.group(2)}.{oa}"] = v.T.contiguous() if t else v
        elif k == "visual.conv1.kernel":
            out["visual.conv1.weight"] = patch_conv(v, patch)
        else:
            out[OPENAI_NAMES.get(k, k.replace(".scale", ".weight"))] = v
    return out


def slip_checkpoint(sd, patch):
    """The port's SLIP state dict as facebookresearch/SLIP publishes one:
    ``{"state_dict": ...}`` with DDP ``module.`` prefixes, a timm image tower,
    CLIP's text tower and an SSL-head tensor the loader must ignore."""
    oa = openai_state_dict(sd, patch, timm_prefix="visual.blocks")
    renames = {"visual.conv1.weight": "visual.patch_embed.proj.weight",
               "visual.conv1.bias": "visual.patch_embed.proj.bias",
               "visual.ln_post.weight": "visual.norm.weight",
               "visual.ln_post.bias": "visual.norm.bias", "visual.proj": "image_projection"}
    out = {renames.get(k, k): v for k, v in oa.items()}
    out["visual.cls_token"] = out.pop("visual.class_embedding").reshape(1, 1, -1)
    out["visual.pos_embed"] = out.pop("visual.positional_embedding")[None]
    width = out["visual.cls_token"].shape[-1]
    out["image_mlp.layer1.weight"] = torch_randn((4 * width, width), seed=17)
    return {"state_dict": {f"module.{k}": v for k, v in out.items()}, "epoch": 0}


def hf_state_dict(oa):
    """An OpenAI-named ViT CLIP state dict in HuggingFace ``CLIPModel``
    naming: the inverse of ``hf_to_openai_state_dict``, written here with no
    ``transformers`` (q / k / v split out of the packed projection, the two
    projections as [out, in] Linears, HF's "pre_layrnorm")."""
    top = {"logit_scale": "logit_scale",
           "token_embedding.weight": "text_model.embeddings.token_embedding.weight",
           "positional_embedding": "text_model.embeddings.position_embedding.weight",
           "ln_final.weight": "text_model.final_layer_norm.weight",
           "ln_final.bias": "text_model.final_layer_norm.bias",
           "visual.class_embedding": "vision_model.embeddings.class_embedding",
           "visual.positional_embedding": "vision_model.embeddings.position_embedding.weight",
           "visual.conv1.weight": "vision_model.embeddings.patch_embedding.weight",
           "visual.ln_pre.weight": "vision_model.pre_layrnorm.weight",
           "visual.ln_pre.bias": "vision_model.pre_layrnorm.bias",
           "visual.ln_post.weight": "vision_model.post_layernorm.weight",
           "visual.ln_post.bias": "vision_model.post_layernorm.bias"}
    block = {"ln_1": "layer_norm1", "ln_2": "layer_norm2", "attn.out_proj": "self_attn.out_proj",
             "mlp.c_fc": "mlp.fc1", "mlp.c_proj": "mlp.fc2"}
    out = {"text_projection.weight": oa["text_projection"].T.contiguous(),
           "visual_projection.weight": oa["visual.proj"].T.contiguous()}
    for k, v in oa.items():
        m = re.match(r"(visual\.transformer|transformer)\.resblocks\.(\d+)\.(.+)\.(\w+)$", k)
        if k in top:
            out[top[k]] = v
        elif m:
            pre = (f"{'vision_model' if m.group(1) != 'transformer' else 'text_model'}"
                   f".encoder.layers.{m.group(2)}")
            if m.group(3) == "attn":  # in_proj_weight / in_proj_bias
                for name, part in zip("qkv", v.chunk(3, dim=0)):
                    out[f"{pre}.self_attn.{name}_proj.{m.group(4)[8:]}"] = part.contiguous()
            else:
                out[f"{pre}.{block[m.group(3)]}.{m.group(4)}"] = v
    return out


def torch_randn(shape, seed):
    import torch

    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def write_class_folders(root, n_classes, per_class, px=224, seed=0):
    """Seeded PNGs in one folder per class (the CLI's zero-shot layout)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for c in range(n_classes):
        os.makedirs(os.path.join(root, f"class{c}"))
        for i in range(per_class):
            Image.fromarray(rng.integers(0, 256, (px, px, 3), dtype=np.uint8)).save(
                os.path.join(root, f"class{c}", f"{i}.png"))


def topk_recount(embs, clf, labels):
    """top-1 / top-5 / n recounted in numpy from embeddings and a classifier."""
    e = embs / np.linalg.norm(embs, axis=-1, keepdims=True)
    order = np.argsort(-(e @ clf.T), axis=-1, kind="stable")
    return {"top1": int((order[:, 0] == labels).sum()) / len(labels),
            "top5": int((order[:, :5] == labels[:, None]).any(-1).sum()) / len(labels),
            "n": len(labels)}


def int8_vs_plain_int8(tag, qmodel, p8, got, ref32):
    """SLIP-L's int8 rung against float32.  The rung's own arithmetic (the
    plain int8 layers, torch._int_mm products: the JAX package's XLA int8
    path) stays below COS_MIN on this random tower (min 0.997749 on an
    H100, ``benchmarks_torch/slip_int8_cosine.py``), so the kernel path is
    held to that route on the same staged batch: its mean cosine error to
    float32 at most INT8_ERR_RATIO times the plain route's, every value
    finite."""
    import torch

    with torch.no_grad():
        plain = qmodel.encode_image(p8, fused=False).float()
    cos_k = torch.nn.functional.cosine_similarity(got, ref32, dim=-1)
    cos_p = torch.nn.functional.cosine_similarity(plain, ref32, dim=-1)
    cos_kp = torch.nn.functional.cosine_similarity(got, plain, dim=-1)
    err_k, err_p = 1 - cos_k.mean().item(), 1 - cos_p.mean().item()
    print(f"{tag}: cosine min {cos_k.min().item():.6f} mean {cos_k.mean().item():.6f}; the "
          f"plain int8 route's min {cos_p.min().item():.6f} mean {cos_p.mean().item():.6f}; "
          f"kernel vs plain int8 min {cos_kp.min().item():.6f} (bar: mean error "
          f"{err_k:.3e} <= {INT8_ERR_RATIO} x the plain route's {err_p:.3e})")
    check(bool(torch.isfinite(got).all()), f"{tag}: non-finite embeddings")
    check(err_k <= INT8_ERR_RATIO * err_p, f"{tag}: the kernels add error to the int8 rung's")


def slip_phase(clip_b16, prompts, card, device):
    """Phase 17: SLIP-ViT-L/16 (published widths, random weights from seed 0)
    through the measurement pipeline at bf16 and int8, checkpoint loading in
    three namings, and zero-shot (function and CLI).  Returns the launch
    counts of K1-K4 over a SLIP_IMAGES-image measurement."""
    import torch
    from debias_vision_lang_torch.cli import FolderDataset
    from debias_vision_lang_torch.data.loader import HostLoader
    from debias_vision_lang_torch.eval import zero_shot as zs
    from debias_vision_lang_torch.eval.measure import (eval_ranking,
                                                      get_labels_img_embeddings,
                                                      get_prompt_embeddings)
    from debias_vision_lang_torch.models.clip import CLIP
    from debias_vision_lang_torch.models.debias import DebiasCLIP
    from debias_vision_lang_torch.models.loader import model_loader
    from debias_vision_lang_torch.ops import fused_block as fb
    from debias_vision_lang_torch.ops import fused_block_q as fbq
    from debias_vision_lang_torch.ops.quant import resolve_compute
    from debias_vision_lang_torch.text import ByteTokenizer

    t0 = time.perf_counter()
    model, _, _, alias = DebiasCLIP.from_cfg(
        {"CLIP_ARCH": SLIP_ARCH, "NUM_DEBIAS_TOKENS": 2, "PRETRAINED": False, "SEED": 0},
        device=device)
    model.eval()
    vis = model.clip_cfg.vision
    check((vis.kind, vis.width, vis.layers, vis.heads, vis.patch_size) ==
          ("slip_vit", 1024, SLIP_LAYERS, 16, 16), f"phase 17: {SLIP_ARCH} is {vis}")
    print(f"phase 17: {alias} ({vis.kind}, D={vis.width}, {vis.layers} layers, {vis.heads} "
          f"heads, ImageNet stats {vis.image_mean}): "
          f"{sum(p.numel() for p in model.parameters())} params, built in "
          f"{time.perf_counter() - t0:.2f} s")
    tok = ByteTokenizer()
    loader = HostLoader(SyntheticFaces(SLIP_IMAGES), batch_size=BATCH, num_workers=8,
                        native_n_px=vis.image_size, native_patch=vis.patch_size)
    p8 = torch.from_numpy(next(iter(loader)).images).to(device)
    with torch.no_grad():
        ref32 = model.encode_image(p8, dtype=torch.float32).float()

    # (a) the measurement pipeline of phase 4 on its first SLIP_IMAGES images,
    # bf16 and int8
    n_batches, counts = SLIP_IMAGES // BATCH, {}
    for rung, blocks in (("bfloat16", ("attention_block", "mlp_block")),
                         ("int8", ("attention_block_q", "mlp_block_q"))):
        m, dt = resolve_compute(model, rung)
        torch.cuda.synchronize()
        fb.reset_launches()
        fbq.reset_launches()
        t = time.perf_counter()
        labels, embs = get_labels_img_embeddings(loader, m, n_px=vis.image_size, dtype=rung)
        prompt_embs = get_prompt_embeddings(m, tok, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {**fb.LAUNCHES, **fbq.LAUNCHES}
        with torch.no_grad():
            tower_ms = cuda_ms(lambda: m.encode_image(p8, dtype=dt), iters=3)
        print(f"phase 17 SLIP-L {rung}: {SLIP_IMAGES} images + {len(prompts)} prompts in "
              f"{wall:.3f} s ({SLIP_IMAGES / wall:.1f} img/s, host clock, in-memory images); "
              f"image tower B={BATCH} {tower_ms:.3f} ms/batch, {BATCH / tower_ms * 1e3:.1f} "
              f"img/s ({card}); launches {launches}")
        for name in blocks:
            check(launches[name] == SLIP_LAYERS * n_batches,
                  f"phase 17 {rung}: {name} launched {launches[name]} times, expected "
                  f"{SLIP_LAYERS} x {n_batches}")
            counts[name] = launches[name]
        check(all(v == 0 for k, v in launches.items() if k not in blocks),
              f"phase 17 {rung}: other kernels launched: {launches}")
        check(embs.shape == (SLIP_IMAGES, vis.embed_dim) and embs.is_cuda,
              f"phase 17 {rung}: image embeddings {tuple(embs.shape)}")
        check_metrics(f"SLIP-L {rung}", labels, embs, prompt_embs, eval_ranking)
        tag = (f"SLIP-L {rung} kernel path vs float32 plain path, image embeddings "
               f"(first {BATCH})")
        if rung == "bfloat16":
            cosine_check(tag, embs[:BATCH], ref32)
        else:
            int8_vs_plain_int8(tag, m, p8, embs[:BATCH], ref32)
        del m, embs

    tmp = tempfile.mkdtemp(prefix="chip_smoke_slip_")
    try:
        # (b) checkpoints in three namings, each loaded through model_loader
        t_b = time.perf_counter()
        tokens = torch.as_tensor(tok(prompts[:64]), dtype=torch.long, device=device)

        def loads_bit_equal(tag, name, ckpt, clip):
            path = os.path.join(tmp, "weights.pt")
            torch.save(ckpt, path)
            t = time.perf_counter()
            loaded, _, _, _ = model_loader(name, device=device, weights=path)
            load_s = time.perf_counter() - t
            with torch.no_grad():
                pairs = [(loaded.encode_image(p8[:64]), clip.encode_image(p8[:64])),
                         (loaded.encode_text(tokens), clip.encode_text(tokens))]
            diff = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
            print(f"phase 17 checkpoint {tag}: {os.path.getsize(path) / 2**30:.2f} GiB, "
                  f"model_loader {load_s:.2f} s; image (bf16 kernels) and text (float32) "
                  f"embeddings vs the original's: max |diff| {diff}")
            check(all(torch.equal(a, b) for a, b in pairs),
                  f"phase 17: the {tag} checkpoint does not load bit-equal")
            os.remove(path)

        sd = {k: v.detach().cpu() for k, v in model.clip.state_dict().items()}
        check("visual.conv1.bias" in sd and not any("ln_pre" in k for k in sd),
              "phase 17: the SLIP tree has no conv bias or has a pre-LN")
        loads_bit_equal("OpenAI-named SLIP-L", SLIP_ARCH, openai_state_dict(sd, 16),
                        model.clip)
        loads_bit_equal("SLIP-named SLIP-L (module. prefixes, SSL head)", SLIP_ARCH,
                        slip_checkpoint(sd, 16), model.clip)
        sd16 = {k: v.detach().cpu() for k, v in clip_b16.state_dict().items()}
        loads_bit_equal("HF-named ViT-B/16", "openai/CLIP/ViT-B/16",
                        hf_state_dict(openai_state_dict(sd16, 16)), clip_b16)
        del sd, sd16
        print(f"phase 17 checkpoints: {time.perf_counter() - t_b:.2f} s")

        # (c) zero-shot: 8 classes x 16 PNGs, the 80 ImageNet templates
        t_c = time.perf_counter()
        root = os.path.join(tmp, "zero_shot")
        write_class_folders(root, 8, 16)
        ds = FolderDataset(root)
        zs_loader = HostLoader(ds, batch_size=BATCH, num_workers=8,
                               native_n_px=vis.image_size)
        templates = zs.imagenet_templates()
        clf32 = None
        for rung, want in (("float32", 0), ("bfloat16", SLIP_LAYERS)):
            seen = []
            hook = model.clip.visual.register_forward_hook(
                lambda mod, inp, out: seen.append(out.detach().float().cpu().numpy()))
            fb.reset_launches()
            t = time.perf_counter()
            acc = zs.zero_shot_accuracy(model, tok, zs_loader, ds.class_names,
                                        templates=templates, dtype=rung)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            hook.remove()
            clf = zs.build_zero_shot_classifier(model, tok, ds.class_names, templates)
            recount = topk_recount(np.concatenate(seen)[: len(ds)], clf.cpu().numpy(),
                                   ds.iat_labels)
            print(f"phase 17 zero-shot {rung}: {acc} in {wall:.2f} s ({len(ds.class_names)} "
                  f"classes x {len(templates)} templates = "
                  f"{len(ds.class_names) * len(templates)} prompts, {len(ds)} images, "
                  f"PIL decode); numpy recount {recount}; K1 / K2 launches "
                  f"{fb.LAUNCHES['attention_block']} / {fb.LAUNCHES['mlp_block']}")
            check(acc == recount and acc["n"] == 128,
                  f"phase 17 zero-shot {rung}: {acc} is not the recount {recount}")
            check(fb.LAUNCHES["attention_block"] == want and fb.LAUNCHES["mlp_block"] == want,
                  f"phase 17 zero-shot {rung}: launches {fb.LAUNCHES}, expected {want} each")
            clf32 = clf if clf32 is None else clf32
        # the card's float32 classifier against the CPU port's, same weights
        t = time.perf_counter()
        cpu_clip = CLIP(model.clip_cfg)
        cpu_clip.load_state_dict(model.clip.state_dict())
        cpu_model = DebiasCLIP(cpu_clip, model.debias_tokens.detach().cpu(), model.debias_cfg)
        clf_cpu = zs.build_zero_shot_classifier(cpu_model, tok, ds.class_names[:2], templates)
        diff = (clf32[:2].cpu() - clf_cpu).abs().max().item()
        print(f"phase 17 zero-shot: float32 classifier, card vs CPU port ({len(templates) * 2} "
              f"prompts of 2 classes): max |diff| {diff} (bar 1e-5; {time.perf_counter() - t:.2f}"
              f" s on the CPU)")
        check(diff <= 1e-5, "phase 17: the card's classifier is not the CPU port's")
        del cpu_clip, cpu_model
        # the CLI, in a process of its own (a toy BPE vocabulary, seed-0 weights)
        vocab = os.path.join(tmp, "bpe_vocab.txt.gz")
        import gzip

        with gzip.open(vocab, "wt", encoding="utf-8") as f:
            f.write("#version: 0.2\nt h\nth e</w>\na </w>\n")
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "debias_vision_lang_torch", "zero-shot", "--data-path",
             root, "--random-weights", "--dtype", "bfloat16", "--model", SLIP_ARCH],
            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
            timeout=600, env=dict(os.environ, DEBIAS_VLT_BPE_PATH=vocab))
        print(f"phase 17 CLI zero-shot: exit {proc.returncode} in "
              f"{time.perf_counter() - t:.2f} s; stdout {proc.stdout.strip()!r}")
        check(proc.returncode == 0, f"phase 17: the zero-shot CLI failed: {proc.stderr[-3000:]}")
        out = json.loads(proc.stdout[proc.stdout.index("{"):])
        check(set(out) == {"top1", "top5", "n"} and out["n"] == 128,
              f"phase 17: the zero-shot CLI printed {out}")
        print(f"phase 17 zero-shot: {time.perf_counter() - t_c:.2f} s")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    del model
    torch.cuda.empty_cache()
    return counts


# phase 18: the ModifiedResNet family at full width and depth
RN_ARCHS = ("RN50", "RN50x4")
# images a ResNet rung measures: one batch (the numpy metrics oracle's NDKL
# at top-n 1.0 takes ~10 s a rung at 1,024; the multi-batch loader runs in
# phases 4, 17 and 19)
RN_IMAGES = BATCH
RN_RUNGS = ("float32", "bfloat16", "int8", "int8-text")
RN_INT8_COS = 0.99  # int8 vs float32 image rows: the JAX package's bar for this rung
RN_TF32_TOL = 1e-4  # card vs CPU float32 tower, of the CPU's largest magnitude
CALIB_SEED = 10 ** 6  # the scenes the BatchNorms' statistics are taken on
BN_NAMES = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def redraw_batch_norms(visual, seed, calibrate=None):
    """Every BatchNorm of a ModifiedResNet redrawn (the init zeroes each
    bottleneck's bn3 scale, which would leave every residual branch dead):
    scale and bias from a seeded generator, scale in [0.5, 1] and in
    [0.1, 0.3] for a bottleneck's bn3 (the end of its residual branch,
    small as CLIP's trained ones grow from their zero init), bias
    N(0, 0.1^2).  The running mean and var are the statistics of each
    BatchNorm's input over the float32 images ``calibrate``, taken layer by
    layer in one forward pass, as training leaves them; without it they are
    drawn too, mean N(0, 0.1^2) and var in [0.5, 2].  Drawn statistics
    leave a per-channel offset common to every image that dominates the
    embeddings (``benchmarks_torch/resnet_image_spread.py``)."""
    import torch
    from debias_vision_lang_torch.models import resnet

    g = torch.Generator().manual_seed(seed)
    ends = {id(m.bn3) for m in visual.modules() if isinstance(m, resnet.Bottleneck)}
    with torch.no_grad():
        for m in visual.modules():
            if isinstance(m, resnet.BatchNorm):
                n = m.scale.shape[0]
                lo, hi = (0.1, 0.3) if id(m) in ends else (0.5, 1.0)
                for p, v in ((m.scale, lo + (hi - lo) * torch.rand(n, generator=g)),
                             (m.bias, 0.1 * torch.randn(n, generator=g)),
                             (m.mean, 0.1 * torch.randn(n, generator=g)),
                             (m.var, 0.5 + 1.5 * torch.rand(n, generator=g))):
                    p.copy_(v)
        if calibrate is None:
            return
        batch_norm = resnet.batch_norm

        def calibrated(p, x):
            rows = x.float().reshape(-1, x.shape[-1])
            p.mean.copy_(rows.mean(0))
            p.var.copy_(rows.var(0, unbiased=False))
            return batch_norm(p, x)

        resnet.batch_norm = calibrated
        try:
            resnet.encode_image_resnet(visual, calibrate)
        finally:
            resnet.batch_norm = batch_norm


def scene_batch(data, vis, device, lo=0, hi=None):
    """Images lo..hi of ``data``, preprocessed on ``device`` for the tower
    ``vis`` (float32 NHWC)."""
    import torch
    from debias_vision_lang_torch.vision.preprocess import preprocess_batch

    u8 = np.stack([data.load_image(i) for i in range(lo, len(data) if hi is None else hi)])
    return preprocess_batch(torch.from_numpy(u8).to(device), vis.image_size,
                            mean=vis.image_mean, std=vis.image_std)


def resnet_openai_state_dict(sd):
    """The port's ResNet CLIP state dict in OpenAI CLIP naming (the inverse of
    ``params_from_openai_state_dict``'s ResNet branch): conv kernels HWIO ->
    OIHW weights, BatchNorm scale / mean / var -> weight / running_mean /
    running_var (with the num_batches_tracked torch keeps), downsample.conv /
    .bn -> downsample.0 / .1, the pool's kernels [in, out] -> Linear weights."""
    import torch

    out = openai_state_dict({k: v for k, v in sd.items() if not k.startswith("visual.")},
                            patch=None)
    for k, v in sd.items():
        if not k.startswith("visual."):
            continue
        stem, leaf = (k.replace(".downsample.conv.", ".downsample.0.")
                      .replace(".downsample.bn.", ".downsample.1.").rsplit(".", 1))
        if leaf == "kernel":
            v = v.T if ".attnpool." in k else v.permute(3, 2, 0, 1)
            out[f"{stem}.weight"] = v.contiguous()
            continue
        out[f"{stem}.{BN_NAMES.get(leaf, leaf) if '.attnpool' not in stem else leaf}"] = v
        if leaf == "var":
            out[f"{stem}.num_batches_tracked"] = torch.tensor(0)
    return out


# the int8 ResNet tower's parts: (label, module of the port, function)
INT8_PARTS = (("quantize", "quant_resnet", "quant_images"), ("quantize", "quant", "quant_rows"),
              ("im2col", "quant_resnet", "im2col"), ("_int_mm", "quant_resnet", "int_mm"),
              ("_int_mm", "fused_block_q", "int_mm"))


def int8_split(fn, total_ms, iters=3):
    """The int8 ResNet tower's device time split by what launched it:
    per-image and per-row quantization, the im2col copies and the int8
    GEMMs (``torch._int_mm``), each a torch.profiler range around the
    port's function; the rest is the tower's CUDA-event time less them.
    Returns ({label: ms per call}, rest ms)."""
    import importlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    saved = []
    for label, mod, name in INT8_PARTS:
        m = importlib.import_module(f"debias_vision_lang_torch.ops.{mod}")
        orig = getattr(m, name)

        def wrapped(*a, _orig=orig, _label=label, **k):
            with record_function(f"int8 split: {_label}"):
                return _orig(*a, **k)

        saved.append((m, name, orig))
        setattr(m, name, wrapped)
    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    finally:
        for m, name, orig in saved:
            setattr(m, name, orig)
    parts = {}
    for ev in prof.key_averages():
        # the CPU-side range (its kernels' device time); the profiler also
        # lists each range on the device timeline under the same name
        if ev.key.startswith("int8 split: ") and ev.device_type == DeviceType.CPU:
            label = ev.key[len("int8 split: "):]
            parts[label] = parts.get(label, 0.0) + ev.device_time_total / iters / 1e3
    return parts, total_ms - sum(parts.values())


def resnet_phase(prompts, card, device):
    """Phase 18: RN50 and RN50x4 (published widths and depths, random weights
    from seed 0, BatchNorms redrawn) through the measurement pipeline at
    every rung, the TF32 witness, an OpenAI-named checkpoint (RN50) and the
    bf16 serving engine (RN50), with cuDNN's TF32 flag at PyTorch's default
    (on).  Returns RN50x4's text-tower launches of K1-K4 (the kernels line's
    D=640 rows)."""
    import torch
    from debias_vision_lang_torch.ops import attention as A
    from debias_vision_lang_torch.ops import fused_block as fb
    from debias_vision_lang_torch.ops import fused_block_q as fbq
    from debias_vision_lang_torch.text import ByteTokenizer

    counters = (fb, fbq, A)
    tok = ByteTokenizer()
    tokens = torch.as_tensor(tok(prompts), dtype=torch.long, device=device)
    rn_launches = {}
    # PyTorch's default: the float32 rung must keep TF32 off by itself
    tf32_default, torch.backends.cudnn.allow_tf32 = torch.backends.cudnn.allow_tf32, True
    try:
        for arch in RN_ARCHS:
            resnet_arch(arch, prompts, tokens, tok, card, device, counters, rn_launches)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32_default
    return rn_launches


def resnet_arch(arch, prompts, tokens, tok, card, device, counters, rn_launches):
    """Phase 18 for one registry ResNet; RN50x4's text launches of K1-K4 go
    into ``rn_launches``."""
    import contextlib

    import torch
    from debias_vision_lang_torch.data.loader import HostLoader
    from debias_vision_lang_torch.eval.measure import (eval_ranking,
                                                      get_labels_img_embeddings,
                                                      get_prompt_embeddings)
    from debias_vision_lang_torch.models import resnet
    from debias_vision_lang_torch.models.debias import DebiasCLIP
    from debias_vision_lang_torch.ops.quant import resolve_compute
    from debias_vision_lang_torch.vision.preprocess import preprocess_batch

    t_arch = time.perf_counter()
    model, _, _, alias = DebiasCLIP.from_cfg(
        {"CLIP_ARCH": f"openai/CLIP/{arch}", "NUM_DEBIAS_TOKENS": 2, "PRETRAINED": False,
         "SEED": 0}, device=device)
    model.eval()
    vis, text_cfg = model.clip_cfg.vision, model.clip_cfg.text
    px = vis.image_size
    redraw_batch_norms(model.clip.visual, seed=18,
                       calibrate=scene_batch(SyntheticScenes(32, seed=CALIB_SEED, px=px),
                                             vis, device))
    print(f"phase 18: {alias} (ModifiedResNet, stages {vis.layers}, stem {vis.width}, "
          f"{vis.heads} pool heads, {px} px; text D={text_cfg.width} H={text_cfg.heads}; "
          f"embed {vis.embed_dim}): {sum(p.numel() for p in model.parameters())} params, "
          f"BatchNorms redrawn and calibrated on 32 other scenes, built in "
          f"{time.perf_counter() - t_arch:.2f} s")
    loader = HostLoader(SyntheticScenes(RN_IMAGES, px=px), batch_size=BATCH, num_workers=8,
                        native_n_px=px)
    u8 = torch.from_numpy(next(iter(loader)).images).to(device)
    x = preprocess_batch(u8, px, mean=vis.image_mean, std=vis.image_std)
    first, t_meas = {}, time.perf_counter()
    for rung in RN_RUNGS:
        m, dt = resolve_compute(model, rung)
        torch.cuda.synchronize()
        reset_all(*counters)
        t = time.perf_counter()
        labels, embs = get_labels_img_embeddings(loader, m, n_px=px, dtype=rung)
        torch.cuda.synchronize()
        img_s = time.perf_counter() - t
        img_launches = launches_of(*counters)
        reset_all(*counters)
        prompt_embs = get_prompt_embeddings(m, tok, prompts)
        torch.cuda.synchronize()
        txt_launches = launches_of(*counters)
        with torch.no_grad():
            tower_ms = cuda_ms(lambda: m.encode_image(x, dtype=dt), iters=3)
        print(f"phase 18 {arch} {rung}: {RN_IMAGES} images in {img_s:.3f} s (host clock, "
              f"in-memory images); image tower B={BATCH} {tower_ms:.3f} ms/batch, "
              f"{BATCH / tower_ms * 1e3:.1f} img/s ({card}); launches: image tower "
              f"{nonzero(img_launches)}, prompts {nonzero(txt_launches)}")
        check(sum(img_launches.values()) == 0,
              f"phase 18 {arch} {rung}: the image tower launched {img_launches}")
        want = dict.fromkeys(img_launches, 0)
        if rung == "int8-text":
            want.update(attention_block_q_causal=LAYERS, mlp_block_q=LAYERS)
        check(txt_launches == want, f"phase 18 {arch} {rung}: prompt launches "
              f"{txt_launches}, expected {want}")
        check(embs.shape == (RN_IMAGES, vis.embed_dim) and embs.device.type == device.type,
              f"phase 18 {arch} {rung}: image embeddings {tuple(embs.shape)} {embs.device}")
        check_metrics(f"{arch} {rung}", labels, embs, prompt_embs, eval_ranking)
        first[rung] = embs[:BATCH]
        if rung == "bfloat16":
            cosine_check(f"{arch} bf16 vs float32, image embeddings (first {BATCH})",
                         embs[:BATCH], first["float32"])
            # the bf16 text tower of this rung: 12 causal K1 + 12 K2
            reset_all(*counters)
            with torch.no_grad():
                txt16 = model.encode_text(tokens, dtype=torch.bfloat16).float()
                txt32 = model.encode_text(tokens).float()
            torch.cuda.synchronize()
            got = launches_of(*counters)
            want = dict.fromkeys(got, 0)
            want.update(attention_block_causal=LAYERS, mlp_block=LAYERS)
            print(f"phase 18 {arch} bf16 text tower (D={text_cfg.width}): launches "
                  f"{nonzero(got)}")
            check(got == want, f"phase 18 {arch}: bf16 text launches {got}, expected {want}")
            cosine_check(f"{arch} bf16 text tower vs float32", txt16, txt32)
            if arch == "RN50x4":
                rn_launches.update(attention_block=got["attention_block_causal"],
                                   mlp_block=got["mlp_block"])
        elif rung != "float32":
            cos = torch.nn.functional.cosine_similarity(embs[:BATCH], first["float32"], -1)
            print(f"{arch} {rung} vs float32, image embeddings (first {BATCH}): cosine min "
                  f"{cos.min().item():.6f} mean {cos.mean().item():.6f} (bar: min >= "
                  f"{RN_INT8_COS})")
            check(bool(torch.isfinite(embs).all()) and cos.min().item() >= RN_INT8_COS,
                  f"phase 18 {arch} {rung}: drift from float32")
        if rung == "int8-text" and arch == "RN50x4":
            rn_launches.update(attention_block_q=txt_launches["attention_block_q_causal"],
                               mlp_block_q=txt_launches["mlp_block_q"])
        if rung == "int8":
            with torch.no_grad():
                parts, rest = int8_split(lambda: m.encode_image(x, dtype=dt), tower_ms)
            split = ("; ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
                     + f"; rest {rest:.3f} ms" if any(parts.values())
                     else "not measured (the profiler gave its ranges no device time)")
            print(f"phase 18 {arch} int8 tower split at B={BATCH} (torch.profiler "
                  f"ranges): {split}; tower {tower_ms:.3f} ms ({card})")
        del m, embs

    # the TF32 witness: the card's float32 tower against the CPU port's
    t_rungs = time.perf_counter()
    cpu = resnet.ModifiedResNet(vis)
    cpu.load_state_dict(model.clip.visual.state_dict())
    x4 = x[:4]
    with torch.no_grad():
        ref = cpu(x4.cpu())
        mag = ref.abs().max().item()
        diff = (model.encode_image(x4).cpu() - ref).abs().max().item()

        @contextlib.contextmanager
        def tf32_on():
            old = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = True
            try:
                yield
            finally:
                torch.backends.cudnn.allow_tf32 = old

        scope, resnet.tf32_off = resnet.tf32_off, tf32_on
        try:
            diff_tf32 = (model.encode_image(x4).cpu() - ref).abs().max().item()
        finally:
            resnet.tf32_off = scope
    print(f"phase 18 {arch} TF32 witness, float32 tower on 4 images, card vs CPU port: "
          f"max |diff| {diff:.3e} (bar {RN_TF32_TOL} x max |CPU| {mag:.4g} = "
          f"{RN_TF32_TOL * mag:.3e}); with cuDNN TF32 on: {diff_tf32:.3e} "
          f"({'over' if diff_tf32 > RN_TF32_TOL * mag else 'within'} the bar; "
          f"{time.perf_counter() - t_rungs:.2f} s) ({card})")
    check(diff <= RN_TF32_TOL * mag, f"phase 18 {arch}: the float32 tower is not the "
          f"CPU port's (TF32 left on?)")
    del cpu

    if arch == "RN50":
        resnet_checkpoint_and_serving(model, x, tokens, tok, card, device, counters)
    print(f"phase 18 {arch}: {time.perf_counter() - t_arch:.2f} s, of it the four rungs "
          f"{t_rungs - t_meas:.2f} s")
    del model, loader, x, u8
    torch.cuda.empty_cache()


def resnet_checkpoint_and_serving(model, x, tokens, tok, card, device, counters):
    """RN50's OpenAI-named .pt loaded back through model_loader (image rows at
    bf16 and text rows at float32 bit-equal), then RN50 in the bf16 serving
    engine: buckets 1 and 64 bit-equal to the direct call on the same staged
    batch, and no kernel launched by the image tower."""
    import shutil

    import torch
    from debias_vision_lang_torch.models.loader import model_loader
    from debias_vision_lang_torch.serve.engine import InferenceEngine
    from debias_vision_lang_torch.vision.preprocess import preprocess_batch

    tmp = tempfile.mkdtemp(prefix="chip_smoke_rn_")
    try:
        path = os.path.join(tmp, "oai-clip-rn50.pt")
        torch.save(resnet_openai_state_dict(
            {k: v.detach().cpu() for k, v in model.clip.state_dict().items()}), path)
        t = time.perf_counter()
        loaded, _, _, _ = model_loader("openai/CLIP/RN50", device=device, weights=path)
        load_s = time.perf_counter() - t
        with torch.no_grad():
            pairs = [(loaded.encode_image(x[:64], dtype=torch.bfloat16),
                      model.encode_image(x[:64], dtype=torch.bfloat16)),
                     (loaded.encode_text(tokens[:64]), model.clip.encode_text(tokens[:64]))]
        diff = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
        print(f"phase 18 checkpoint OpenAI-named RN50: {os.path.getsize(path) / 2**20:.1f} "
              f"MiB, model_loader {load_s:.2f} s; image (bf16) and text (float32) embeddings "
              f"vs the original's: max |diff| {diff}")
        check(all(torch.equal(a, b) for a, b in pairs),
              "phase 18: the OpenAI-named RN50 checkpoint does not load bit-equal")
        del loaded
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    engine = InferenceEngine(model, tok, max_batch=64, compute_dtype="bfloat16", device=device)
    check(engine._patch is None, "phase 18: the engine stages a ResNet patch-contiguously")
    px = engine.n_px
    rng = np.random.default_rng(18)
    vis = model.clip_cfg.vision
    for n in (1, 64):
        frames = [rng.integers(0, 256, (px, px, 3), dtype=np.uint8) for _ in range(n)]
        reset_all(*counters)
        t = time.perf_counter()
        rows = engine.embed_image_arrays(frames)
        serve_ms = (time.perf_counter() - t) * 1e3
        launches = launches_of(*counters)
        staged = torch.from_numpy(np.stack(frames)).to(device)
        with torch.no_grad():
            want = model.encode_image(preprocess_batch(staged, px, mean=vis.image_mean,
                                                       std=vis.image_std),
                                      dtype=torch.bfloat16).float().cpu().numpy()
        diff = float(np.abs(np.asarray(rows) - want).max())
        print(f"phase 18 serving RN50 bf16 bucket {n}: {serve_ms:.2f} ms host clock; rows vs "
              f"the direct call max |diff| {diff}; launches {nonzero(launches)} ({card})")
        check(np.array_equal(np.asarray(rows), want),
              f"phase 18: the engine's bucket-{n} rows are not the direct call's")
        check(sum(launches.values()) == 0, f"phase 18: the image dispatch launched {launches}")


# phase 19: the Frozen-in-Time video family at full width and depth
FIT_ARCH = "m-bain/frozen-in-time/base"
FIT_VIDEOS, FIT_BATCH, FIT_FRAMES, FIT_FILE_FRAMES = 64, 32, 4, 6
FIT_RUNGS = ("float32", "bfloat16", "int8", "int8-text")
FIT_COS = {"bfloat16": 0.999, "int8": 0.99, "int8-text": 0.99}  # rows vs float32
FIT_F32_TOL = 1e-4  # card vs CPU float32 tower, of the CPU's largest magnitude
FIT_PALLAS_F32_TOL = 2e-5  # use_pallas vs not at float32, of the largest magnitude
FIT_PALLAS_COS = 0.9999  # the same at bfloat16
FAIRFACE_RACES = ("White", "Southeast Asian", "Middle Eastern", "Black", "Indian",
                  "Latino_Hispanic", "East Asian")
FAIRFACE_AGES = ("0-2", "3-9", "10-19", "20-29", "30-39", "40-49", "50-59", "60-69",
                 "more than 70")


def video_frames(rng, px, frames):
    """One seeded video: a 4 x 4 colour grid that drifts from frame to frame
    (N(0, 24^2) per frame), bilinearly upsampled, plus uniform noise of
    +-48.  iid noise frames embed nearly alike through a random tower, and
    the metrics-vs-oracle bar then reads float32 rounding (as phase 18's
    scenes, ``benchmarks_torch/resnet_image_spread.py``)."""
    grid = rng.uniform(0, 255, (4, 4, 3))
    out = []
    for _ in range(frames):
        grid = np.clip(grid + rng.normal(0, 24, grid.shape), 0, 255)
        img = upsample_grid(grid, px) + rng.integers(-48, 49, (px, px, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


GIF_LEVELS = np.arange(6) * 51  # the 6 x 6 x 6 palette of the written GIFs


def write_videos(root, n, px=224, frames=FIT_FILE_FRAMES, seed=19):
    """``n`` seeded videos at ``px`` (``video_frames``): the even ones frame
    directories of ``frames`` PNGs named with unpadded numbers (frame_2,
    frame_4, ..., frame_12: frame_10 sorts before frame_2 unless the order
    is natural), the odd ones animated GIFs of ``frames`` frames mapped onto
    a fixed 6 x 6 x 6 palette here (written as P images, so PIL quantizes
    nothing); a labels.csv in FairFace's vocabulary, genders alternating.
    Written on a thread pool."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    palette = np.stack(np.meshgrid(GIF_LEVELS, GIF_LEVELS, GIF_LEVELS, indexing="ij"),
                       -1).reshape(-1, 3).astype(np.uint8).tobytes()

    def one(i):
        imgs = video_frames(np.random.default_rng(seed + i), px, frames)
        if i % 2 == 0:
            name = f"vid{i}"
            os.makedirs(os.path.join(root, name))
            for k, img in enumerate(imgs):
                Image.fromarray(img).save(os.path.join(root, name, f"frame_{2 * k + 2}.png"))
        else:
            name = f"vid{i}.gif"
            ims = []
            for img in imgs:
                q = (img.astype(np.int32) * 6) // 256  # the palette level of each channel
                im = Image.fromarray((q[..., 0] * 36 + q[..., 1] * 6 + q[..., 2]).astype(
                    np.uint8), mode="P")
                im.putpalette(palette)
                ims.append(im)
            ims[0].save(os.path.join(root, name), save_all=True, append_images=ims[1:])
        return {"file": name, "gender": "Male" if i % 2 else "Female",
                "race": FAIRFACE_RACES[i % 7], "age": FAIRFACE_AGES[i % 9]}

    with ThreadPoolExecutor(8) as pool:
        rows = list(pool.map(one, range(n)))
    with open(os.path.join(root, "labels.csv"), "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=["file", "gender", "race", "age"])
        w.writeheader()
        w.writerows(rows)


def redraw_temporal(visual, seed):
    """The temporal embedding and every temporal out-projection (wo, bo)
    drawn from a seeded generator: the init zeroes them, and a tower drawn
    that way runs its temporal path as the identity."""
    import torch

    g = torch.Generator().manual_seed(seed)
    w = visual.cfg.width
    a = visual.temporal_attn.attn
    with torch.no_grad():
        for p, std in ((visual.temporal_embedding, 0.5), (a.wo, w ** -0.5), (a.bo, 0.1)):
            p.copy_((torch.randn(p.shape, generator=g) * std).to(p.device))


def fit_checkpoint(sd):
    """The port's Frozen-in-Time image tower in m-bain/frozen-in-time naming
    ({"state_dict": {"module.video_model.*", "module.vid_proj.0.*"}}): the
    inverse of ``convert.from_fit_state_dict`` (torch Linear weights [out,
    in], the patch conv [D, 3, p, p])."""
    v = {k[len("visual."):]: t for k, t in sd.items() if k.startswith("visual.")}
    w = v["class_embedding"].shape[0]
    p = int(round((v["conv1.kernel"].shape[0] // 3) ** 0.5))
    out = {
        "video_model.cls_token": v["class_embedding"].reshape(1, 1, w),
        "video_model.pos_embed": v["positional_embedding"][None],
        "video_model.temporal_embed": v["temporal_embedding"][None],
        "video_model.patch_embed.proj.weight":
            v["conv1.kernel"].reshape(p, p, 3, w).permute(3, 2, 0, 1).contiguous(),
        "video_model.patch_embed.proj.bias": v["conv1.bias"],
        "video_model.norm.weight": v["ln_post.scale"], "video_model.norm.bias": v["ln_post.bias"],
        "vid_proj.0.weight": v["proj.kernel"].T.contiguous(), "vid_proj.0.bias": v["proj.bias"],
    }
    layers = v["temporal_attn.attn.wo"].shape[0]
    for i in range(layers):
        b, r = f"video_model.blocks.{i}", f"resblocks.{i}"
        for ours, theirs in (("ln_1", "norm1"), ("ln_2", "norm2")):
            out[f"{b}.{theirs}.weight"] = v[f"{r}.{ours}.scale"]
            out[f"{b}.{theirs}.bias"] = v[f"{r}.{ours}.bias"]
        for ours, theirs in (("attn.wqkv", "attn.qkv.weight"), ("attn.wo", "attn.proj.weight"),
                             ("mlp.w1", "mlp.fc1.weight"), ("mlp.w2", "mlp.fc2.weight")):
            out[f"{b}.{theirs}"] = v[f"{r}.{ours}"].T.contiguous()
        for ours, theirs in (("attn.bqkv", "attn.qkv.bias"), ("attn.bo", "attn.proj.bias"),
                             ("mlp.b1", "mlp.fc1.bias"), ("mlp.b2", "mlp.fc2.bias")):
            out[f"{b}.{theirs}"] = v[f"{r}.{ours}"]
        out[f"{b}.norm3.weight"] = v["temporal_attn.ln_t.scale"][i]
        out[f"{b}.norm3.bias"] = v["temporal_attn.ln_t.bias"][i]
        out[f"{b}.timeattn.qkv.weight"] = v["temporal_attn.attn.wqkv"][i].T.contiguous()
        out[f"{b}.timeattn.qkv.bias"] = v["temporal_attn.attn.bqkv"][i]
        out[f"{b}.timeattn.proj.weight"] = v["temporal_attn.attn.wo"][i].T.contiguous()
        out[f"{b}.timeattn.proj.bias"] = v["temporal_attn.attn.bo"][i]
    return {"state_dict": {f"module.{k}": t.clone() for k, t in out.items()}}


def fit_phase(prompts, card, device, n_videos=FIT_VIDEOS):
    """Phase 19: Frozen-in-Time (ViT-B/16 over 4 frames, published widths,
    random weights from seed 0, temporal weights redrawn) as a DebiasCLIP
    through measure_bias(dataset="video") at every rung, joint and
    divided; use_pallas on the towers; the float32 witness; an m-bain-named
    checkpoint; the embedding cache's formulation key.  Returns the K3 / K4
    launches of the int8 joint measurement (the kernels line's FiT row)."""
    import shutil

    import torch
    from debias_vision_lang_torch.eval.measure import measure_bias
    from debias_vision_lang_torch.models.debias import DebiasCLIP
    from debias_vision_lang_torch.ops import attention as A
    from debias_vision_lang_torch.ops import fused_block as fb
    from debias_vision_lang_torch.ops import fused_block_q as fbq
    from debias_vision_lang_torch.text import ByteTokenizer

    counters = (fb, fbq, A)
    t_phase = time.perf_counter()
    model, preprocess, _, alias = DebiasCLIP.from_cfg(
        {"CLIP_ARCH": FIT_ARCH, "NUM_DEBIAS_TOKENS": 2, "PRETRAINED": False, "SEED": 0},
        device=device)
    model.eval()
    fit, vis = model.clip, model.clip_cfg.vision
    redraw_temporal(fit.visual, seed=19)
    check((vis.kind, vis.width, vis.layers, vis.heads, vis.patch_size, vis.image_size) ==
          ("video_vit", 768, LAYERS, 12, 16, 224), f"phase 19: {FIT_ARCH} is {vis}")
    print(f"phase 19: {alias} ({vis.kind}, D={vis.width}, {vis.layers} layers, {vis.heads} "
          f"heads, {FIT_FRAMES} frames, ImageNet stats {vis.image_mean}): "
          f"{sum(p.numel() for p in model.parameters())} params, temporal weights redrawn, "
          f"built in {time.perf_counter() - t_phase:.2f} s")
    tok = ByteTokenizer()
    tokens = torch.as_tensor(tok(prompts), dtype=torch.long, device=device)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fit_")
    launches_out = {}
    try:
        t = time.perf_counter()
        root = os.path.join(tmp, "videos")
        os.makedirs(root)
        write_videos(root, n_videos)
        print(f"phase 19: {n_videos} videos written in {time.perf_counter() - t:.2f} s "
              f"({n_videos // 2} frame directories of {FIT_FILE_FRAMES} PNGs, "
              f"{n_videos - n_videos // 2} GIFs of {FIT_FILE_FRAMES} frames, 224 px)")
        from debias_vision_lang_torch.data.loader import HostLoader
        from debias_vision_lang_torch.data.video import VideoDataset
        from debias_vision_lang_torch.vision.preprocess import preprocess_batch

        ds = VideoDataset(root, iat_type="gender", num_frames=FIT_FRAMES)
        first = next(iter(HostLoader(ds, batch_size=FIT_BATCH, num_workers=8,
                                     native_n_px=vis.image_size))).images
        check(first.shape == (FIT_BATCH, FIT_FRAMES, 224, 224, 3),
              f"phase 19: a staged batch is {first.shape}")
        u8 = torch.from_numpy(first).to(device)
        x = preprocess_batch(u8.reshape((-1,) + u8.shape[2:]), vis.image_size,
                             mean=vis.image_mean, std=vis.image_std).reshape(
                                 u8.shape[:2] + (224, 224, 3))
        caches = {}
        for mode in ("joint", "divided"):
            fit.attention = mode
            caches[mode] = fit_measure(model, preprocess, mode, root, prompts, tokens, tok, x,
                                       n_videos, counters, card, launches_out, tmp)
            fit_pallas(model, mode, x[:8], card)
        fit.attention = "joint"
        fit_witness(fit, x[:2], card)
        fit_checkpoint_check(model, tmp, x[:2], device)
        # the embedding cache: the joint tower's file refuses the divided one
        fit.attention = "divided"
        opts = {"dataset": "video", "data_path": root, "num_frames": FIT_FRAMES,
                "batch_size": FIT_BATCH, "dtype": "bfloat16",
                "cache_embeddings": caches["joint"]}
        reset_all(*counters)
        try:
            measure_bias(model, preprocess, tok, "gender", opts=opts)
            refused = None
        except ValueError as e:
            refused = str(e)
        print(f"phase 19 embedding cache: the joint tower's file for the divided tower "
              f"(same tensors): {'refused' if refused else 'read'}; launches "
              f"{nonzero(launches_of(*counters))}")
        check(refused is not None and "the cached labels would be wrong" in refused
              and '"video_attention": "joint"' in refused,
              "phase 19: the divided tower read the joint tower's cached embeddings")
        check(sum(launches_of(*counters).values()) == 0,
              "phase 19: the refused cache call launched kernels")
        fit.attention = "joint"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s ({card})")
    del model
    torch.cuda.empty_cache()
    return launches_out


def fit_measure(model, preprocess, mode, root, prompts, tokens, tok, x, n_videos, counters,
                card, launches_out, tmp):
    """One formulation of phase 19 through measure_bias(dataset="video") at
    every rung: launches and core routes, metrics against the oracle,
    cosines against float32, videos/s and frames/s.  Returns the bf16
    measurement's cache file."""
    import torch
    from debias_vision_lang_torch.eval.measure import (eval_ranking, get_prompt_embeddings,
                                                      measure_bias)
    from debias_vision_lang_torch.ops import fused_block as fb
    from debias_vision_lang_torch.ops import fused_block_q as fbq
    from debias_vision_lang_torch.ops.quant import resolve_compute

    first32, cache_bf16 = None, None
    n_batches = -(-n_videos // FIT_BATCH)
    q_route = "long" if mode == "joint" else "short"
    for rung in FIT_RUNGS:
        cache = os.path.join(tmp, f"{mode}_{rung}.npz")
        opts = {"dataset": "video", "data_path": root, "num_frames": FIT_FRAMES,
                "batch_size": FIT_BATCH, "num_workers": 8, "dtype": rung, "topn": 1.0,
                "cache_embeddings": cache}
        torch.cuda.synchronize()
        reset_all(*counters)
        t = time.perf_counter()
        metrics = measure_bias(model, preprocess, tok, "gender", opts=opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches, routes = launches_of(*counters), dict(fbq.CORE_ROUTES)
        m, dt = resolve_compute(model, rung)
        with torch.no_grad():
            tower_ms = cuda_ms(lambda: m.encode_image(x, dtype=dt), iters=3)
        vid_s = FIT_BATCH / tower_ms * 1e3
        print(f"phase 19 {mode} {rung}: measure_bias over {n_videos} videos + "
              f"{len(prompts)} prompts in {wall:.3f} s (host clock, PIL decode of the files); "
              f"video tower B={FIT_BATCH} {tower_ms:.3f} ms/batch, {vid_s:.1f} videos/s, "
              f"{vid_s * FIT_FRAMES:.1f} frames/s ({card}); launches {nonzero(launches)}, "
              f"K3 core routes {routes}")
        want = dict.fromkeys(launches, 0)
        want_routes = {"short": 0, "long": 0}
        if rung in ("int8", "int8-text"):
            want.update(attention_block_q=LAYERS * n_batches, mlp_block_q=LAYERS * n_batches)
            want_routes[q_route] += LAYERS * n_batches
        if rung == "int8-text":
            want.update(attention_block_q_causal=LAYERS)
            want["mlp_block_q"] += LAYERS
            want_routes["short"] += LAYERS
        check(launches == want, f"phase 19 {mode} {rung}: launches {launches}, expected {want}")
        check(routes == want_routes,
              f"phase 19 {mode} {rung}: K3 core routes {routes}, expected {want_routes}")
        if rung == "int8" and mode == "joint":
            launches_out.update(attention_block_q=launches["attention_block_q"],
                                mlp_block_q=launches["mlp_block_q"])
        with np.load(cache) as data:
            labels, embs = data["labels"], torch.from_numpy(data["embeddings"]).to(x.device)
        check(tuple(embs.shape) == (n_videos, model.clip_cfg.vision.embed_dim)
              and len(labels) == n_videos, f"phase 19 {mode} {rung}: embeddings {embs.shape}")
        prompt_embs = get_prompt_embeddings(m, tok, prompts)
        for ev in metrics:
            ref = eval_ranking(labels, embs, prompt_embs, ev, 1.0)
            check(all(abs(metrics[ev][k] - ref[k]) <= METRIC_ATOL for k in ref),
                  f"phase 19 {mode} {rung}: measure_bias's {ev} {metrics[ev]} is not the "
                  f"ranking of its cached rows {ref}")
        check_metrics(f"FiT {mode} {rung}", labels, embs, prompt_embs, eval_ranking)
        if rung == "float32":
            first32 = embs
            unit = torch.nn.functional.normalize(embs, dim=-1)
            pair = (unit @ unit.T)[~torch.eye(len(unit), dtype=torch.bool, device=unit.device)]
            print(f"FiT {mode} float32: the videos' pairwise embedding cosines span "
                  f"{pair.min().item():.4f} to {pair.max().item():.4f}")
        else:
            cos = torch.nn.functional.cosine_similarity(embs, first32, dim=-1)
            print(f"FiT {mode} {rung} vs float32, video embeddings ({len(embs)}): cosine min "
                  f"{cos.min().item():.6f} mean {cos.mean().item():.6f} (bar: min >= "
                  f"{FIT_COS[rung]})")
            check(bool(torch.isfinite(embs).all()) and cos.min().item() >= FIT_COS[rung],
                  f"phase 19 {mode} {rung}: drift from float32")
        if rung == "bfloat16":
            cache_bf16 = cache
            # the bf16 text tower of this rung: 12 causal K1 + 12 K2
            reset_all(*counters)
            with torch.no_grad():
                txt16 = model.encode_text(tokens, dtype=torch.bfloat16).float()
                txt32 = model.encode_text(tokens).float()
            torch.cuda.synchronize()
            got = launches_of(*counters)
            want = dict.fromkeys(got, 0)
            want.update(attention_block_causal=LAYERS, mlp_block=LAYERS)
            check(got == want and fb.CORE_ROUTES == {"short": LAYERS, "long": 0},
                  f"phase 19 {mode}: bf16 text launches {got}, routes {fb.CORE_ROUTES}")
            cosine_check(f"FiT {mode} bf16 text tower vs float32", txt16, txt32)
        del m
    return cache_bf16


def fit_pallas(model, mode, x8, card):
    """use_pallas=True on 8 videos through encode_image, float32 and
    bfloat16: the joint tower's 12 attentions on K5's long route (785
    tokens), the divided tower's 24 on its short route (4 and 196 tokens);
    held to use_pallas=False."""
    import torch
    from debias_vision_lang_torch.ops import attention as A
    from debias_vision_lang_torch.ops import fused_block as fb
    from debias_vision_lang_torch.ops import fused_block_q as fbq

    want = ({"attention_pallas": 0, "attention_pallas_long": LAYERS} if mode == "joint"
            else {"attention_pallas": 2 * LAYERS, "attention_pallas_long": 0})
    for dt in (torch.float32, torch.bfloat16):
        with torch.no_grad():
            ref = model.encode_image(x8, dtype=dt).float()
            torch.cuda.synchronize()
            reset_all(A, fb, fbq)
            got = model.encode_image(x8, dtype=dt, use_pallas=True).float()
            torch.cuda.synchronize()
        launched = {**A.LAUNCHES, **nonzero({**fb.LAUNCHES, **fbq.LAUNCHES})}
        mag = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1).min().item()
        name = "float32" if dt == torch.float32 else "bfloat16"
        print(f"phase 19 {mode} use_pallas {name} (8 videos): launches {launched}; vs "
              f"use_pallas=False max |diff| {err:.3e} of max {mag:.4g}, cosine min {cos:.7f} "
              f"(bar: {'%g x max' % FIT_PALLAS_F32_TOL if dt == torch.float32 else f'cosine >= {FIT_PALLAS_COS}'}) "
              f"({card})")
        check(launched == want, f"phase 19 {mode} use_pallas {name}: launches {launched}, "
                                f"expected {want}")
        if dt == torch.float32:
            check(err <= FIT_PALLAS_F32_TOL * mag, f"phase 19 {mode}: use_pallas drifts at f32")
        else:
            check(cos >= FIT_PALLAS_COS, f"phase 19 {mode}: use_pallas drifts at bf16")


def fit_witness(fit, x2, card):
    """2 videos through the card's float32 towers (joint and divided) and the
    CPU port's, same weights."""
    import torch
    from debias_vision_lang_torch.models.frozen_in_time import FrozenInTime

    t = time.perf_counter()
    cpu = FrozenInTime(fit.cfg)
    cpu.load_state_dict({k: v.detach().cpu() for k, v in fit.state_dict().items()})
    with torch.no_grad():
        for mode in ("joint", "divided"):
            ref = cpu.visual(x2.cpu(), attention=mode)
            got = fit.visual(x2, attention=mode).cpu()
            mag = ref.abs().max().item()
            diff = (got - ref).abs().max().item()
            print(f"phase 19 float32 witness {mode}, 2 videos, card vs CPU port: max |diff| "
                  f"{diff:.3e} (bar {FIT_F32_TOL} x max |CPU| {mag:.4g}) ({card})")
            check(diff <= FIT_F32_TOL * mag,
                  f"phase 19: the card's float32 {mode} tower is not the CPU port's")
    print(f"phase 19 float32 witness: {time.perf_counter() - t:.2f} s")


def fit_checkpoint_check(model, tmp, x2, device):
    """The tower written in m-bain naming and loaded through model_loader:
    bit-equal, "divided" (a trained temporal out-projection), and "joint"
    once timeattn.proj is zeroed."""
    import warnings

    import torch
    from debias_vision_lang_torch.models.loader import model_loader

    t = time.perf_counter()
    sd = {k: v.detach().cpu() for k, v in model.clip.state_dict().items()}
    ckpt = fit_checkpoint(sd)
    path = os.path.join(tmp, "mbain-fit-base.pt")
    for zero in (False, True):
        if zero:
            for k, v in ckpt["state_dict"].items():
                if ".timeattn.proj." in k:
                    v.zero_()
        torch.save(ckpt, path)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            loaded, _, _, _ = model_loader(FIT_ARCH, device=device, weights=path)
        text_warned = any("no text tower" in str(w.message) for w in caught)
        got = {k: v.cpu() for k, v in loaded.state_dict().items() if k.startswith("visual.")}
        want = "joint" if zero else "divided"
        if not zero:
            same = all(torch.equal(got[k], sd[k]) for k in got) and set(got) == {
                k for k in sd if k.startswith("visual.")}
            with torch.no_grad():
                emb = torch.equal(loaded.encode_image(x2), model.clip.visual(
                    x2, attention="divided"))
            print(f"phase 19 checkpoint m-bain-named: {os.path.getsize(path) / 2**20:.1f} MiB; "
                  f"video tower bit-equal {same}, float32 divided embeddings bit-equal {emb}; "
                  f"the text tower drawn with a warning {text_warned}")
            check(same and emb and text_warned,
                  "phase 19: the m-bain-named checkpoint does not load bit-equal")
        print(f"phase 19 checkpoint {'timeattn.proj zeroed' if zero else 'as trained'}: the "
              f"loader runs {loaded.attention!r} (cfg {loaded.cfg.vision.video_attention!r})")
        check(loaded.attention == loaded.cfg.vision.video_attention == want,
              f"phase 19: the loader chose {loaded.attention!r}, expected {want!r}")
        del loaded
    print(f"phase 19 checkpoints: {time.perf_counter() - t:.2f} s")


# phase 20: distribution on the one card
DIST_DATA = 4  # the virtual mesh: four data shards on the one card
DIST_N = 254  # its ragged batch: padded to 256, four shards of 64 rows
DIST_VAL = 256  # the written FairFace val images of measure_bias and the world
DIST_ATOL = 1e-5  # sharded metrics vs the oracle; the two-rank world vs one process
# the trainer under the mesh against the unsharded trainer: at float32 the
# first token gradient and the first update, as cosines; every token within
# Adam's per-element bound, 2 x lr a step (the image rows of a 16-row shard
# round otherwise in cuBLAS, and from then on Adam steps an element whose
# gradient is rounding noise by ~lr either way; see STEP3_UPDATE_COS).  The
# bf16 step's gradient moves with ulp-sized changes of its image rows (its
# cosine with the unsharded step's 0.9982, PERF.md section 6): it is held
# to phase 11's bf16 bars, UPDATE_COS_BF16 and UPDATE_FLIP_MAX_BF16
DIST_UPDATE_COS = 0.9999
DIST_ADAM_BOUND = 2 * 2e-3 * TRAIN_STEPS  # TrainConfig.prompt_lr
DIST_CLASSES, DIST_PER_CLASS, DIST_ZS_BATCH = 4, 16, 30  # zero-shot: batches of 30, 30, 4


def rows_equal(tag, got, want):
    """Bit-equal, or within one bf16 ulp of the largest magnitude; returns
    the largest difference in those ulp."""
    diff = (got.float() - want.float()).abs().max().item()
    mag = want.float().abs().max().item()
    ulps = diff / ulp_bf16(mag)
    if diff == 0:
        print(f"{tag}: bit-equal")
    else:
        print(f"{tag}: not bit-equal: largest difference {diff} = {ulps:.3f} bf16 ulp of the "
              f"largest magnitude {mag} (the patch-embedding and projection matmuls run "
              f"through torch.matmul, and cuBLAS may pick another algorithm, with another "
              f"summation order, at the shard's M); bar 1 ulp")
    check(ulps <= 1, f"{tag}: the mesh's rows drift from the unsharded call's")
    return ulps


def planted_ties(embs, prompts, how):
    """(embeddings, prompts) with exact boundary ties planted.  Both are
    quantized first (each to -1, 0, 1 at 0.7 of its spread: the scores are
    integers) so every score is exact in float32 whatever the summation
    order: rows that are equal then score equal in every shard and every
    GEMM tile, as they do in the oracle.  Then each row is replaced by one
    of 20 distinct rows, or every row is made equal but one."""
    import torch

    e = torch.round(embs / (0.7 * embs.std())).clamp(-1, 1)
    p = torch.round(prompts / (0.7 * prompts.std())).clamp(-1, 1)
    n = e.shape[0]
    if how == "20 distinct rows":
        e = e[torch.arange(n, device=e.device) % 20]
    elif how == "all tied but one":
        row5 = e[5].clone()
        e = e[:1].expand(n, -1).clone()
        e[5] = row5
    return e, p


def trainer_digest(trainer) -> str:
    """sha256 over every tensor both optimizers hold (the prompt array, the
    trained CLIP tensors, the adversary) and their Adam moments: equal on
    two ranks only if their state is bit-equal."""
    import hashlib

    h = hashlib.sha256()
    for opt in (trainer.prompt_opt, trainer.adv_opt):
        tensors = list(opt.params) + [v for st in opt.adam.state.values()
                                      for v in st.values()]
        for t in tensors:
            h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def layered_model(model):
    """A copy of ``model`` whose top image layer trains (n_train_vid_layers=1)."""
    m = copy.deepcopy(model)
    m.debias_cfg = dataclasses.replace(m.debias_cfg, n_train_vid_layers=1)
    return m


WORLD_STEPS = 2  # the two-rank world's with-layers trainer
WORLD_TRAIN = {"train_dtype": "bfloat16", "embed_dtype": "bfloat16"}


def dist_rank(rank: int, init: str, ff: str, out: str) -> int:
    """One rank of phase 20's two-rank world (both ranks on cuda:0, gloo):
    the phase-4 model, measure_bias(mesh="auto", sharded_metrics=True), then
    WORLD_STEPS bf16 steps of a trainer whose top image layer trains, with
    a digest of its state after every step."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from debias_vision_lang_torch.eval.measure import gen_prompts, measure_bias
    from debias_vision_lang_torch.models.debias import DebiasCLIP
    from debias_vision_lang_torch.ops import attention as A
    from debias_vision_lang_torch.ops import fused_block as fb
    from debias_vision_lang_torch.ops import fused_block_q as fbq
    from debias_vision_lang_torch.parallel import mesh as pmesh
    from debias_vision_lang_torch.text import ByteTokenizer
    from debias_vision_lang_torch.vision.preprocess import Preprocess

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    check(pmesh.init_distributed("file://" + init, 2, rank), "no two-rank world")
    try:
        model, _, tokenizer, _ = DebiasCLIP.from_cfg(
            {"CLIP_ARCH": "openai/CLIP/ViT-B/16", "PRETRAINED": False,
             "NUM_DEBIAS_TOKENS": 2, "DEBIAS_POS": "prepend", "SEED": 0}, device="cuda")
        model.eval()
        mesh = pmesh.default_mesh("cuda")
        torch.cuda.synchronize()
        reset_all(fb, fbq, A)
        t1 = time.perf_counter()
        res = measure_bias(model, Preprocess(224), tokenizer or ByteTokenizer(), "gender",
                           opts={"data_path": ff, "dtype": "bfloat16", "batch_size": BATCH,
                                 "topn": 0.1, "mesh": "auto", "sharded_metrics": True})
        torch.cuda.synchronize()
        measure_launches = nonzero(launches_of(fb, fbq, A))
        measure_s = time.perf_counter() - t1
        tok = tokenizer or ByteTokenizer()
        digests = []
        run = run_trainer(layered_model(model), tok(gen_prompts()),
                          train_batches(tok, model.clip_cfg.vision, "cuda")[:WORLD_STEPS],
                          (fb, fbq, A), mesh="auto",
                          on_step=lambda tr: digests.append(trainer_digest(tr)), **WORLD_TRAIN)
        with open(out, "w") as f:
            json.dump({"measure": res, "mesh": dict(mesh.shape), "world": mesh.world,
                       "devices": sorted({str(d) for d in mesh.devices.flat}),
                       "backend": dist.get_backend(), "collectives": dict(pmesh.COLLECTIVES),
                       "launches": measure_launches, "measure_s": measure_s,
                       "train": {"digests": digests, "grad": run["grad"].tolist(),
                                 "update": run["updates"][0].tolist(),
                                 "counts": run["counts"], "metrics": run["metrics"],
                                 "times": run["times"]},
                       "wall_s": time.perf_counter() - t0}, f)
    finally:
        dist.destroy_process_group()
    return 0


def dist_phase(model, qmodel, tokenizer, prompts, card, device):
    """Phase 20: the distribution path on the one card (see the docstring)."""
    import torch
    from debias_vision_lang_torch.cli import FolderDataset
    from debias_vision_lang_torch.data.loader import HostLoader
    from debias_vision_lang_torch.eval import zero_shot as zs
    from debias_vision_lang_torch.eval.measure import (get_labels_img_embeddings,
                                                      get_prompt_embeddings, measure_bias)
    from debias_vision_lang_torch.metrics import distributed as mdist
    from debias_vision_lang_torch.metrics.oracle import eval_ranking_oracle
    from debias_vision_lang_torch.ops import attention as A
    from debias_vision_lang_torch.ops import fused_block as fb
    from debias_vision_lang_torch.ops import fused_block_q as fbq
    from debias_vision_lang_torch.parallel import mesh as pmesh
    from debias_vision_lang_torch.serve.engine import InferenceEngine
    from debias_vision_lang_torch.vision.preprocess import Preprocess

    counters = (fb, fbq, A)
    walls = {}
    kernels = {"bfloat16": ("attention_block", "mlp_block"),
               "int8": ("attention_block_q", "mlp_block_q")}
    rungs = (("bfloat16", model), ("int8", qmodel))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        # 20.1 measure_bias with mesh="auto" (one slot on the one card)
        t0 = time.perf_counter()
        ff = os.path.join(tmp, "fairface")
        write_fairface(ff, 0, DIST_VAL)
        single = {}
        for rung, m in rungs:
            opts = {"data_path": ff, "dtype": rung, "batch_size": BATCH, "topn": 0.1,
                    "prompts": prompts}
            single[rung] = measure_bias(m, Preprocess(224), tokenizer, "gender", opts=opts)
            torch.cuda.synchronize()
            reset_all(*counters)
            auto = measure_bias(m, Preprocess(224), tokenizer, "gender",
                                opts={**opts, "mesh": "auto"})
            torch.cuda.synchronize()
            got = nonzero(launches_of(*counters))
            print(f"phase 20 measure_bias {rung}, mesh='auto' (data = "
                  f"{pmesh.default_mesh('cuda').shape['data']}): {json.dumps(auto)}; "
                  f"launches {got}")
            check(auto == single[rung], f"measure_bias {rung}: mesh='auto' is not bit-equal "
                                        f"to the unsharded call: {auto} vs {single[rung]}")
            check(got == {k: LAYERS for k in kernels[rung]},
                  f"measure_bias {rung} under mesh='auto' launched {got}")
        walls["20.1 measure_bias mesh='auto' (4 calls)"] = time.perf_counter() - t0

        # 20.2 a virtual 4-way mesh on the one card, a ragged batch of 254
        t0 = time.perf_counter()
        mesh4 = pmesh.create_mesh(devices=[device] * DIST_DATA)
        loader = HostLoader(SyntheticFaces(DIST_N, seed=200), batch_size=DIST_N,
                            num_workers=8, native_n_px=224, native_patch=16)
        escalations = []
        orig = mdist._sharded_metrics
        mdist._sharded_metrics = lambda *a: escalations.append(a[-1]) or orig(*a)
        try:
            for rung, m in rungs:
                torch.cuda.synchronize()
                reset_all(*counters)
                labels1, e1 = get_labels_img_embeddings(loader, m, n_px=224, dtype=rung)
                torch.cuda.synchronize()
                c1 = nonzero(launches_of(*counters))
                reset_all(*counters)
                labels4, e4 = get_labels_img_embeddings(loader, m, n_px=224, dtype=rung,
                                                        mesh=mesh4)
                torch.cuda.synchronize()
                c4 = nonzero(launches_of(*counters))
                print(f"phase 20 {rung} embed of {DIST_N} images: launches unsharded {c1}, "
                      f"under the {DIST_DATA}-way mesh {c4}")
                check(c1 == {k: LAYERS for k in kernels[rung]}, f"unsharded launches {c1}")
                check(c4 == {k: DIST_DATA * LAYERS for k in kernels[rung]},
                      f"the {DIST_DATA}-way mesh launched {c4}")
                check(np.array_equal(labels4, labels1) and e4.shape == (DIST_N, e1.shape[1]),
                      "the mesh's labels or rows differ in number")
                rows_equal(f"phase 20 {rung} image rows, {DIST_DATA}-way mesh vs unsharded",
                           e4, e1)
                prm = get_prompt_embeddings(m, tokenizer, prompts)
                plants = ("as embedded", "quantized", "20 distinct rows", "all tied but one")
                worst = 0.0
                for how in plants:
                    e, p = (e4, prm) if how == "as embedded" else planted_ties(e4, prm, how)
                    for ev in ("maxskew", "ndkl"):
                        for topn in TOPNS:
                            got = mdist.sharded_eval_ranking(labels4, e, p, ev, topn, mesh4)
                            ref = eval_ranking_oracle(labels4, e.cpu().numpy(),
                                                      p.cpu().numpy(), ev, topn)
                            for k in ref:
                                worst = max(worst, abs(got[k] - ref[k]))
                                check(abs(got[k] - ref[k]) <= DIST_ATOL,
                                      f"sharded {rung} {how} {ev}@{topn}/{k}: {got[k]} vs "
                                      f"oracle {ref[k]}")
                print(f"phase 20 {rung} sharded metrics ({', '.join(plants)}; maxskew and "
                      f"ndkl at top-n {TOPNS}): largest difference from the numpy oracle "
                      f"{worst} (bar {DIST_ATOL})")
        finally:
            mdist._sharded_metrics = orig
        budgets = sorted(set(escalations))
        print(f"phase 20 sharded metrics: per-shard budgets run {budgets} (the shard's "
              f"{DIST_N // DIST_DATA + 1} rows = an escalation)")
        check(DIST_N // DIST_DATA + 1 in budgets, "no planted tie escalated the shard budget")
        # the virtual mesh's overhead on the one card: four launches of 64 rows
        x = torch.from_numpy(next(iter(HostLoader(SyntheticFaces(BATCH, seed=200),
                                                   batch_size=BATCH, num_workers=8,
                                                   native_n_px=224,
                                                   native_patch=16))).images).to(device)
        sharded = pmesh.dp_shard_map(mesh4, lambda mm, xx: mm.encode_image(
            xx, dtype=torch.bfloat16))
        times = {}
        with torch.no_grad():
            for label in ("unsharded", "mesh", "mesh", "unsharded"):
                fn = ((lambda: model.encode_image(x, dtype=torch.bfloat16))
                      if label == "unsharded" else (lambda: sharded(model, x)))
                times.setdefault(label, []).append(cuda_ms(fn, iters=5))
        t_one, t_mesh = (min(times[k]) for k in ("unsharded", "mesh"))
        print(f"phase 20 bf16 image tower B={BATCH}: unsharded {t_one:.3f} ms, the "
              f"{DIST_DATA}-way virtual mesh {t_mesh:.3f} ms ({t_mesh / t_one - 1:+.1%}: pure "
              f"overhead on one card, {DIST_DATA} launches of {BATCH // DIST_DATA} rows; "
              f"all {json.dumps(times)}) ({card})")
        walls["20.2 virtual mesh embeds, sharded metrics, overhead"] = time.perf_counter() - t0

        # 20.3 zero-shot under the same mesh
        t0 = time.perf_counter()
        zs_root = os.path.join(tmp, "classes")
        write_class_folders(zs_root, DIST_CLASSES, DIST_PER_CLASS)
        ds = FolderDataset(zs_root)
        preds = {}
        orig_classify = zs.classify
        for name, mesh in (("unsharded", None), ("mesh", mesh4)):
            rec = []
            zs.classify = lambda *a, **k: rec.append(orig_classify(*a, **k)) or rec[-1]
            try:
                reset_all(*counters)
                acc = zs.zero_shot_accuracy(
                    model, tokenizer, HostLoader(ds, batch_size=DIST_ZS_BATCH, num_workers=8,
                                                 native_n_px=224),
                    ds.class_names, dtype="bfloat16", mesh=mesh)
                torch.cuda.synchronize()
            finally:
                zs.classify = orig_classify
            if mesh is not None:  # per batch: the shards' rows, less the mesh's pad rows
                rec = [torch.cat(rec[i:i + DIST_DATA])[:DIST_ZS_BATCH]
                       for i in range(0, len(rec), DIST_DATA)]
            preds[name] = (acc, torch.cat(rec), nonzero(launches_of(*counters)))
        (a1, p1, c1), (a4, p4, c4) = preds["unsharded"], preds["mesh"]
        print(f"phase 20 zero-shot bf16, {DIST_CLASSES * DIST_PER_CLASS} images in batches of "
              f"{DIST_ZS_BATCH}: unsharded {a1} launches {c1}; mesh {a4} launches {c4}")
        check(a4 == a1 and torch.equal(p4, p1), "zero-shot top-k under the mesh differs")
        n_zs = -(-DIST_CLASSES * DIST_PER_CLASS // DIST_ZS_BATCH)
        check(c4.get("attention_block") == DIST_DATA * LAYERS * n_zs,
              f"zero-shot under the mesh launched {c4}")
        walls["20.3 zero-shot"] = time.perf_counter() - t0

        # 20.4 the serving engine at data = 4: every bucket's rows against the
        # mesh's own direct call on the same staged bucket (the engine changes
        # no number: bit-equal) and, reported, against the unsharded call
        t0 = time.perf_counter()
        eng = InferenceEngine(model, tokenizer, max_batch=64, compute_dtype="bfloat16",
                              mesh=mesh4, device=device)
        check(eng.min_bucket == DIST_DATA and eng.info()["mesh"] == {"data": DIST_DATA,
                                                                      "model": 1},
              f"engine mesh {eng.info()['mesh']}")
        direct = {kind: pmesh.dp_shard_map(mesh4, fn) for kind, fn in (
            ("image", lambda mm, xx: mm.encode_image(xx, dtype=torch.bfloat16).float()),
            ("text", lambda mm, tt: mm.encode_text(tt, dtype=torch.bfloat16).float()))}
        faces = SyntheticFaces(64, seed=300)
        vs_unsharded = {}
        reset_all(*counters)
        buckets = (4, 8, 16, 32, 64)
        for b in buckets:
            items = [faces.load_image(i) for i in range(b)]
            toks = np.asarray(tokenizer(prompts[:b]), np.int64)
            got = {"image": eng.fetch(eng.dispatch_image_arrays(items), b),
                   "text": eng.fetch(eng.dispatch_token_arrays(list(toks)), b)}
            staged = {"image": torch.from_numpy(np.stack([staged_image(eng, i)
                                                          for i in items])).to(device),
                      "text": torch.from_numpy(toks).to(device)}
            for kind in ("image", "text"):
                with torch.inference_mode():
                    mesh_rows = direct[kind](model, staged[kind]).cpu()
                    one = (model.encode_image(staged[kind], dtype=torch.bfloat16)
                           if kind == "image" else
                           model.encode_text(staged[kind], dtype=torch.bfloat16)).float().cpu()
                check(torch.equal(torch.from_numpy(got[kind]), mesh_rows),
                      f"engine {kind} bucket {b}: the dispatch differs from the mesh's direct "
                      f"call on the same staged bucket")
                diff = (mesh_rows - one).abs().max().item()
                vs_unsharded[f"{kind} {b}"] = diff / ulp_bf16(one.abs().max().item())
        torch.cuda.synchronize()
        got = nonzero(launches_of(*counters))
        n_disp = len(buckets)
        per = (2 * DIST_DATA + 1) * LAYERS * n_disp  # dispatch, mesh direct, unsharded
        want_c = {"attention_block": per, "attention_block_causal": per, "mlp_block": 2 * per}
        print(f"phase 20 engine at data = {DIST_DATA}, buckets {buckets}, both towers: every "
              f"dispatch bit-equal to the mesh's direct call on the same staged bucket; "
              f"against the unsharded call, largest difference in bf16 ulp of the largest "
              f"magnitude {json.dumps({k: round(v, 3) for k, v in vs_unsharded.items()})} "
              f"(not gated: at bucket {DIST_DATA} each shard holds one row, and the stem and "
              f"projection matmuls run through cuBLAS, whose algorithm, and with it the "
              f"summation order, may change with M); launches {got}")
        check(got == want_c, f"engine launches {got}, expected {want_c}")
        walls["20.4 serving engine"] = time.perf_counter() - t0

        # 20.5 the trainer under the mesh: frozen and with-layers at float32
        # (K5, use_pallas=True), and the bf16 kernels' frozen step
        t0 = time.perf_counter()
        sens = tokenizer(prompts)
        batches = train_batches(tokenizer, model.clip_cfg.vision, device)
        with_layers = layered_model(model)
        for tag, m0, kw in (("float32 frozen", model, {"use_pallas": True}),
                            ("float32 with-layers", with_layers, {"use_pallas": True}),
                            ("bf16 kernels frozen", model,
                             {"train_dtype": "bfloat16", "embed_dtype": "bfloat16"})):
            runs = {}
            for name, mesh in (("unsharded", None), ("mesh", mesh4)):
                runs[name] = run_trainer(m0, sens, batches, counters, mesh=mesh, **dict(kw))
                check_run(f"phase 20 trainer {tag} {name}", runs[name])
            t1, t4 = (runs[k]["model"].debias_tokens.detach() for k in ("unsharded", "mesh"))
            start = m0.debias_tokens.detach()
            diff = (t4 - t1).abs().max().item()
            cos_u = cosine(runs["mesh"]["updates"][0], runs["unsharded"]["updates"][0])
            cos_g = cosine(runs["mesh"]["grad"], runs["unsharded"]["grad"])
            print(f"phase 20 trainer {tag}, {TRAIN_STEPS} steps under the mesh: first token "
                  f"gradient cosine {cos_g:.7f}, first update cosine {cos_u:.7f}"
                  + (f" (bar {DIST_UPDATE_COS} on both)" if tag.startswith("float32") else "")
                  + f"; the {TRAIN_STEPS} steps' update cosine "
                  f"{cosine(t4 - start, t1 - start):.7f}; tokens within {diff:.3g} = "
                  f"{diff / t1.abs().max().item():.3g} of the largest magnitude (Adam's "
                  f"bound 2 x lr x steps = {DIST_ADAM_BOUND:.3g}); launches unsharded "
                  f"{nonzero(runs['unsharded']['counts'])}, mesh "
                  f"{nonzero(runs['mesh']['counts'])}")
            if tag.startswith("float32"):
                check(min(cos_g, cos_u) >= DIST_UPDATE_COS,
                      f"trainer {tag}: the step drifts under the mesh")
            else:  # phase 11's bf16 bars: the bf16 step moves with ulp-sized inputs
                u4, u1 = runs["mesh"]["updates"][0], runs["unsharded"]["updates"][0]
                flips = (u4.sign() != u1.sign()).double().mean().item()
                print(f"phase 20 trainer {tag}: first update sign flips {flips:.6f} of the "
                      f"elements (bar {UPDATE_FLIP_MAX_BF16}), gradient bar {UPDATE_COS_BF16}")
                check(cos_g >= UPDATE_COS_BF16 and flips <= UPDATE_FLIP_MAX_BF16,
                      f"trainer {tag}: the step drifts under the mesh")
            check(diff <= DIST_ADAM_BOUND, f"trainer {tag}: tokens past Adam's bound")
            # the image passes launch once per shard: 2 a step frozen; with layers
            # 3, and the trained top layer's forward again in its backward
            # (remat_image_tower) once per differentiable pass
            want = dict(runs["unsharded"]["counts"])
            img = 3 * LAYERS + 2 if "with-layers" in tag else 2 * LAYERS
            for k in (("attention_pallas",) if tag.startswith("float32")
                      else ("attention_block", "mlp_block")):
                want[k] += (DIST_DATA - 1) * img * TRAIN_STEPS
            check(runs["mesh"]["counts"] == want,
                  f"trainer {tag}: launches under the mesh {runs['mesh']['counts']}, "
                  f"expected {want}")
            for r in runs.values():
                del r["trainer"], r["model"]
        del with_layers
        torch.cuda.empty_cache()
        walls["20.5 trainer (6 runs of 3 steps)"] = time.perf_counter() - t0

        # 20.6 a two-rank world on the one card: gloo, file:// rendezvous
        t0 = time.perf_counter()
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dist-rank",
                                   str(r), os.path.join(tmp, "rendezvous"), ff, outs[r]],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for r in range(2)]
        try:
            logs = [p.communicate(timeout=300)[0].decode()[-3000:] for p in procs]
        finally:
            for p in procs:
                p.kill()
        check([p.returncode for p in procs] == [0, 0], f"the two-rank world failed: {logs}")
        ranks = [json.load(open(o)) for o in outs]
        for r, res in enumerate(ranks):
            print(f"phase 20 world rank {r}: mesh {res['mesh']} over {res['devices']} in a "
                  f"world of {res['world']}, backend {res['backend']}, collectives "
                  f"{res['collectives']}, launches {res['launches']}, measure_bias "
                  f"{res['measure_s']:.2f} s of {res['wall_s']:.2f} s ({card})")
            check(res["world"] == 2 and res["mesh"] == {"data": 2, "model": 1},
                  f"rank {r}: mesh {res['mesh']}")
            check(res["launches"] == {k: LAYERS for k in kernels["bfloat16"]},
                  f"rank {r} launched {res['launches']}")
            worst = max(abs(res["measure"][ev][k] - single["bfloat16"][ev][k])
                        for ev in single["bfloat16"] for k in single["bfloat16"][ev])
            print(f"phase 20 world rank {r}: metrics {json.dumps(res['measure'])}, within "
                  f"{worst} of one process (bar {DIST_ATOL})")
            check(worst <= DIST_ATOL, f"rank {r}: the world's metrics differ from one process")
        check(ranks[0]["measure"] == ranks[1]["measure"], "the two ranks' metrics differ")
        # the with-layers bf16 trainer: the ranks' state bit-equal after every
        # step, the first step held to one process by phase 11's bf16 bars
        # (the image rows of a 32-row shard round otherwise in cuBLAS)
        t1 = time.perf_counter()
        ref = run_trainer(layered_model(model), sens, batches[:WORLD_STEPS], counters,
                          **WORLD_TRAIN)
        check_run("phase 20 world with-layers, one process", ref)
        digests = [r["train"]["digests"] for r in ranks]
        check(len(digests[0]) == WORLD_STEPS and digests[0] == digests[1],
              f"the two ranks' trainer state differs after a step: {digests}")
        for r, res in enumerate(ranks):
            tr = res["train"]
            g = torch.tensor(tr["grad"], dtype=torch.float32)
            u = torch.tensor(tr["update"], dtype=torch.float32)
            u1 = ref["updates"][0].cpu()
            cos_g = cosine(g, ref["grad"].cpu())
            flips = (u.sign() != u1.sign()).double().mean().item()
            print(f"phase 20 world rank {r} with-layers bf16 trainer, {WORLD_STEPS} steps: "
                  f"losses {[m['loss'] for m in tr['metrics']]}, steps "
                  f"{[round(t * 1e3, 1) for t in tr['times']]} ms (host clock); state digest "
                  f"after each step {[d[:12] for d in tr['digests']]} (both ranks equal); "
                  f"first token gradient vs one process cosine {cos_g:.6f} (bar "
                  f"{UPDATE_COS_BF16}), first update sign flips {flips:.6f} (bar "
                  f"{UPDATE_FLIP_MAX_BF16}), update cosine {cosine(u, u1):.6f}; launches "
                  f"{nonzero(tr['counts'])} (one process {nonzero(ref['counts'])})")
            check(cos_g >= UPDATE_COS_BF16 and flips <= UPDATE_FLIP_MAX_BF16,
                  f"rank {r}: the with-layers step drifts from one process")
            check(tr["counts"] == ref["counts"] and tr["counts"]["attention_block"] > 0,
                  f"rank {r}: trainer launches {tr['counts']}, one process {ref['counts']}")
        check(ranks[0]["train"]["metrics"] == ranks[1]["train"]["metrics"],
              "the two ranks' losses differ")
        del ref["trainer"], ref["model"]
        walls["20.6 two-rank world (2 processes)"] = time.perf_counter() - t0
        print(f"phase 20 the one-process with-layers reference: "
              f"{time.perf_counter() - t1:.2f} s")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    for k, v in walls.items():
        print(f"phase 20 wall {k}: {v:.2f} s ({card})")
    return sum(walls.values())


# phase 21: the "auto" rung, and the registry archs no phase ran before
RUNG_ARCHS = ("openai/CLIP/ViT-B/32", "openai/CLIP/ViT-L/14",
              "facebookresearch/SLIP/ViT-B/16", "openai/CLIP/RN101")
RUNGS = ("float32", "bfloat16", "int8", "int8-text")
# int8 image rows vs float32: the absolute bar (COS_MIN) on ViT-B/32, the
# relative one of phase 17 (INT8_ERR_RATIO) where random weights take the
# int8 rung itself under it, RN_INT8_COS on the ResNet
RUNG_INT8_BAR = {"openai/CLIP/ViT-B/32": "absolute", "openai/CLIP/ViT-L/14": "relative",
                 "facebookresearch/SLIP/ViT-B/16": "relative", "openai/CLIP/RN101": "resnet"}
# K1-K4 at the shapes the sweep runs first on the card: (case, B, S, D, heads,
# causal, MLP activation, weight seed)
RUNG_SHAPES = (("ViT-B/32 B=256 S=50 D=768", BATCH, 50, 768, 12, False, "quick_gelu", 32),
               ("ViT-L/14 B=256 S=257 D=1024", BATCH, 257, 1024, 16, False, "quick_gelu", 14),
               ("ViT-L/14 text B=319 S=77 D=768", 319, 77, 768, 12, True, "quick_gelu", 77))
AUTO_VAL = 256  # the written FairFace val images of the entry-point checks
AUTO_VIDEOS = 32  # and the written videos (one batch of FIT_BATCH)


def rung_kernels(fb, fbq, device, card):
    """K1-K4 against their twins at RUNG_SHAPES, timed: kernels-line rows
    without launch counts, keyed by (name, case)."""
    import torch

    rows = {}
    for case, b, s, d, heads, causal, act, seed in RUNG_SHAPES:
        g = torch.Generator().manual_seed(seed)
        x = torch.randn(b, s, d, generator=g).to(device, torch.bfloat16)
        attn, mlp = block_params(d, device, seed=seed)
        qattn, qmlp = q_block_params(d, device, seed=seed)
        akw, mkw = {"heads": heads, "causal": causal}, {"act_kind": act}
        iters = 3 if s > 200 else 5
        for name, lib, line, kern, plain, args, qkw, kw, work in (
                ("attention_block", "fused_block", 69, fb.attention_block,
                 fb.attention_block_plain, attn, {}, akw,
                 attention_block_work(b, s, d, causal=causal)),
                ("mlp_block", "fused_block", 192, fb.mlp_block, fb.mlp_block_plain, mlp, {},
                 mkw, mlp_block_work(b, s, d, 4 * d)),
                ("attention_block_q", "fused_block_q", 62, fbq.attention_block_q,
                 fbq.attention_block_q_plain, qattn[0], qattn[1], akw,
                 attention_block_work(b, s, d, causal=causal, weights="int8")),
                ("mlp_block_q", "fused_block_q", 106, fbq.mlp_block_q, fbq.mlp_block_q_plain,
                 qmlp[0], qmlp[1], mkw, mlp_block_work(b, s, d, 4 * d, weights="int8"))):
            label = f"{name} {case} H={heads} causal={causal} {act} (phase 21)"
            if lib == "fused_block":
                err = compare_bf16(label, x, kern(x, *args, **kw), plain(x, *args, **kw))
            else:
                err = compare_q(fbq, label, kern, plain, x, (args, qkw), kw)
            rows[name, case] = kernel_row(
                name, case, lib, line, err,
                cuda_ms(lambda: kern(x, *args, **kw, **qkw), iters=iters),
                cuda_ms(lambda: plain(x, *args, **kw), iters=2), work)
            r = rows[name, case]
            print(f"time {name} {case}: kernel {r['ms']:.4f} ms, plain twin "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}; the "
                  f"kernel at {r['bound_ms'] / r['ms']:.1%} of it) ({card})")
        del x, attn, mlp, qattn, qmlp
    torch.cuda.empty_cache()
    return rows


def rung_tower(arch, tok, prompts, counters, card, device, table, tower_launches):
    """One registry arch at full width and depth, seed 0: its image tower at
    every rung (img/s at B=256, CUDA events; launches of one forward; rows
    against float32), ViT-L/14's text tower at bf16 and int8-text.  Returns
    the model and its preprocess (SLIP-B/16 goes on to the entry-point
    checks)."""
    import torch
    from debias_vision_lang_torch.data.loader import HostLoader
    from debias_vision_lang_torch.models.loader import model_loader
    from debias_vision_lang_torch.ops.quant import resolve_compute, resolve_rung

    t0 = time.perf_counter()
    model, pre, _, alias = model_loader(arch, device=device, pretrained=False)
    model.eval()
    vis, text = model.cfg.vision, model.cfg.text
    resnet = vis.kind == "resnet"
    if resnet:
        redraw_batch_norms(model.visual, seed=21, calibrate=scene_batch(
            SyntheticScenes(32, seed=CALIB_SEED, px=vis.image_size), vis, device))
        x = scene_batch(SyntheticScenes(BATCH, seed=21, px=vis.image_size), vis, device)
        layers = 0
    else:
        x = torch.from_numpy(next(iter(HostLoader(
            SyntheticFaces(BATCH, seed=21, px=vis.image_size), batch_size=BATCH,
            num_workers=8, native_n_px=vis.image_size,
            native_patch=vis.patch_size))).images).to(device)
        layers = vis.layers
    print(f"phase 21 {alias}: {vis.kind}, image D={vis.width} layers {vis.layers} heads "
          f"{vis.heads} patch {vis.patch_size} at {vis.image_size} px (staged "
          f"{tuple(x.shape)} {x.dtype}), text D={text.width} H={text.heads}; "
          f"{sum(p.numel() for p in model.parameters())} params, built in "
          f"{time.perf_counter() - t0:.2f} s")
    kernels = {"bfloat16": ("attention_block", "mlp_block"),
               "int8": ("attention_block_q", "mlp_block_q"),
               "int8-text": ("attention_block_q", "mlp_block_q"), "float32": ()}
    embs, img_s = {}, {}
    for rung in RUNGS:
        m, dt = resolve_compute(model, rung)
        torch.cuda.synchronize()
        reset_all(*counters)
        with torch.no_grad():
            emb = m.encode_image(x, dtype=dt).float()
        torch.cuda.synchronize()
        got = nonzero(launches_of(*counters))
        want = {} if resnet else {k: layers for k in kernels[rung]}
        check(got == want, f"phase 21 {arch} {rung}: one forward launched {got}, expected {want}")
        check(emb.shape == (BATCH, vis.embed_dim) and bool(torch.isfinite(emb).all()),
              f"phase 21 {arch} {rung}: image rows {tuple(emb.shape)}")
        with torch.no_grad():
            ms = cuda_ms(lambda: m.encode_image(x, dtype=dt), iters=2)
        img_s[rung] = BATCH / ms * 1e3
        print(f"phase 21 {arch} {rung}: image tower B={BATCH} {ms:.3f} ms/batch, "
              f"{img_s[rung]:.1f} img/s; launches per forward {got} ({card})")
        for name, n in got.items():
            tower_launches[name, vis.width, vis.kind] = n
        embs[rung] = emb
        if rung == "float32":
            continue
        tag = f"phase 21 {arch} {rung} vs float32, image rows (B={BATCH})"
        bar = RUNG_INT8_BAR[arch] if rung != "bfloat16" else "absolute"
        if bar == "absolute":
            cosine_check(tag, emb, embs["float32"])
        elif bar == "relative":
            int8_vs_plain_int8(tag, m, x, emb, embs["float32"])
        else:
            cos = torch.nn.functional.cosine_similarity(emb, embs["float32"], -1)
            print(f"{tag}: cosine min {cos.min().item():.6f} mean {cos.mean().item():.6f} "
                  f"(bar: min >= {RN_INT8_COS})")
            check(cos.min().item() >= RN_INT8_COS, f"{tag}: drift from float32")
        del m
    auto = resolve_rung(model, "auto")
    fast = max(("float32", "bfloat16", "int8"), key=img_s.get)
    table[arch] = (img_s, auto, fast)
    if arch == "openai/CLIP/ViT-L/14":  # its text tower: D = 768, 12 heads
        tokens = torch.as_tensor(tok(prompts), dtype=torch.long, device=device)
        with torch.no_grad():
            txt32 = model.encode_text(tokens).float()
            for rung, want in (("bfloat16", ("attention_block_causal", "mlp_block")),
                               ("int8-text", ("attention_block_q_causal", "mlp_block_q"))):
                m, dt = resolve_compute(model, rung)
                reset_all(*counters)
                txt = (m.encode_text(tokens) if rung == "int8-text"
                       else m.encode_text(tokens, dtype=dt)).float()
                torch.cuda.synchronize()
                got = nonzero(launches_of(*counters))
                print(f"phase 21 {arch} {rung} text tower, {len(prompts)} prompts (D="
                      f"{text.width}): launches {got}")
                check(got == {k: text.layers for k in want},
                      f"phase 21 {arch} {rung} text tower launched {got}")
                for name, n in got.items():
                    tower_launches[name.replace("_causal", ""), text.width, "text"] = n
                cosine_check(f"phase 21 {arch} {rung} text tower vs float32", txt, txt32)
                del m
    del embs, x
    torch.cuda.empty_cache()
    return model, pre


def auto_measure(tag, model, pre, tok, prompts, opts, rung, want, counters, tmp):
    """measure_bias(dtype="auto") through the entry point against the
    explicit rung's call: metrics, cached embeddings and cache key bit for
    bit, the resolved rung's launches, and an "auto" call that hits the
    rung's cache file (no launch)."""
    import torch
    from debias_vision_lang_torch.eval.measure import measure_bias

    t0 = time.perf_counter()
    out = {}
    for dt in (rung, "auto"):
        path = os.path.join(tmp, f"{tag.replace('/', '_')}_{dt}.npz")
        torch.cuda.synchronize()
        reset_all(*counters)
        res = measure_bias(model, pre, tok, "gender", opts={
            **opts, "prompts": prompts, "dtype": dt, "cache_embeddings": path})
        torch.cuda.synchronize()
        with np.load(path) as f:
            out[dt] = (res, f["embeddings"], str(f["cache_key"]),
                       nonzero(launches_of(*counters)), path)
    (r1, e1, k1, c1, p1), (r2, e2, k2, c2, _) = out[rung], out["auto"]
    check(r2 == r1, f"phase 21 {tag}: auto's metrics {r2} are not the {rung} call's {r1}")
    check(np.array_equal(e2, e1) and k2 == k1 and json.loads(k2)["dtype"] == rung,
          f"phase 21 {tag}: auto's embeddings or cache key differ from the {rung} call's")
    check(c2 == c1 == want, f"phase 21 {tag}: launches auto {c2}, {rung} {c1}, expected {want}")
    reset_all(*counters)
    hit = measure_bias(model, pre, tok, "gender", opts={
        **opts, "prompts": prompts, "dtype": "auto", "cache_embeddings": p1})
    torch.cuda.synchronize()
    hit_launches = nonzero(launches_of(*counters))
    check(hit == r1 and not hit_launches,
          f"phase 21 {tag}: auto on the {rung} cache file gave {hit}, launches {hit_launches}")
    print(f"phase 21 measure_bias {tag}: dtype='auto' -> {rung}: metrics, embeddings and "
          f"cache key bit-equal to the explicit call, launches {c2}; auto on the {rung} "
          f"call's cache file: a hit, no launch ({time.perf_counter() - t0:.2f} s)")


def rung_phase(model, tokenizer, prompts, card, device, tower_img_s=None):
    """Phase 21: K1-K4 at the sweep's new shapes against their twins; every
    rung of ViT-B/32, ViT-L/14, SLIP-B/16 and RN101 at full width; the
    "auto" rung through measure_bias (the phase-4 ViT-B/16, SLIP-B/16, RN50,
    the Frozen-in-Time joint tower), the engine, zero-shot and the CLI.
    Returns (the kernels line's rows of the new shapes, the wall time)."""
    import gzip
    import shutil

    import torch
    from debias_vision_lang_torch.cli import FolderDataset
    from debias_vision_lang_torch.data.loader import HostLoader
    from debias_vision_lang_torch.eval.zero_shot import zero_shot_accuracy
    from debias_vision_lang_torch.models.loader import model_loader
    from debias_vision_lang_torch.ops import attention as A
    from debias_vision_lang_torch.ops import fused_block as fb
    from debias_vision_lang_torch.ops import fused_block_q as fbq
    from debias_vision_lang_torch.serve.engine import InferenceEngine
    from debias_vision_lang_torch.text import ByteTokenizer
    from debias_vision_lang_torch.vision.preprocess import Preprocess

    counters = (fb, fbq, A)
    walls = {}
    t0 = time.perf_counter()
    rows = rung_kernels(fb, fbq, device, card)
    walls["21.1 K1-K4 at the new shapes"] = time.perf_counter() - t0
    tok = ByteTokenizer()
    table, tower_launches = {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rung_")
    try:
        t0 = time.perf_counter()
        ff = os.path.join(tmp, "fairface")
        write_fairface(ff, 0, AUTO_VAL)
        opts = {"data_path": ff, "batch_size": BATCH, "topn": 0.1}
        slip = None
        for arch in RUNG_ARCHS:
            m = rung_tower(arch, tok, prompts, counters, card, device, table, tower_launches)
            if arch == "facebookresearch/SLIP/ViT-B/16":
                slip = m
            del m
            torch.cuda.empty_cache()
        walls["21.2 the sweep (4 archs x 4 rungs)"] = time.perf_counter() - t0

        # 21.3 measure_bias(dtype="auto") for one arch of each family
        t0 = time.perf_counter()
        n_b = AUTO_VAL // BATCH
        q_launch = {"attention_block_q": LAYERS * n_b, "mlp_block_q": LAYERS * n_b}
        auto_measure("ViT-B/16 (phase 4)", model, Preprocess(model.clip_cfg.vision.image_size),
                     tokenizer, prompts, opts, "int8", q_launch, counters, tmp)
        auto_measure("SLIP-ViT-B/16", *slip, tokenizer, prompts, opts, "int8", q_launch,
                     counters, tmp)
        del slip
        rn, rn_pre, _, _ = model_loader("openai/CLIP/RN50", device=device, pretrained=False)
        rn.eval()
        redraw_batch_norms(rn.visual, seed=21, calibrate=scene_batch(
            SyntheticScenes(32, seed=CALIB_SEED, px=rn.cfg.vision.image_size), rn.cfg.vision,
            device))
        auto_measure("RN50", rn, rn_pre, tokenizer, prompts, opts, "bfloat16", {}, counters,
                     tmp)
        del rn
        fit, fit_pre, _, _ = model_loader(FIT_ARCH, device=device, pretrained=False)
        fit.eval()
        redraw_temporal(fit.visual, seed=21)
        vids = os.path.join(tmp, "videos")
        os.makedirs(vids)
        write_videos(vids, AUTO_VIDEOS)
        auto_measure(f"Frozen-in-Time {fit.attention}", fit, fit_pre, tokenizer, prompts,
                     {"dataset": "video", "data_path": vids, "num_frames": FIT_FRAMES,
                      "batch_size": FIT_BATCH, "topn": 0.1}, "int8",
                     {"attention_block_q": LAYERS * AUTO_VIDEOS // FIT_BATCH,
                      "mlp_block_q": LAYERS * AUTO_VIDEOS // FIT_BATCH}, counters, tmp)
        del fit
        torch.cuda.empty_cache()
        walls["21.3 measure_bias auto, four families"] = time.perf_counter() - t0

        # 21.4 the engine and zero-shot at "auto" (the phase-4 model: int8)
        t0 = time.perf_counter()
        faces = SyntheticFaces(64, seed=21, px=model.clip_cfg.vision.image_size)
        items = [faces.load_image(i) for i in range(64)]
        rows_by = {}
        for dt in ("auto", "int8"):
            eng = InferenceEngine(model, tokenizer, max_batch=64, compute_dtype=dt,
                                  device=device)
            reset_all(*counters)
            rows_by[dt] = eng.embed_image_arrays(items)
            torch.cuda.synchronize()
            launches = nonzero(launches_of(*counters))
            info = eng.info()
            print(f"phase 21 engine compute_dtype={dt!r}: precision {info['precision']!r}, "
                  f"compute_dtype {info['compute_dtype']!r}, launches {launches}")
            check(launches == {"attention_block_q": LAYERS, "mlp_block_q": LAYERS},
                  f"phase 21 engine {dt}: launches {launches}")
            check(info["precision"] == dt and info["compute_dtype"] == "bfloat16",
                  f"phase 21 engine {dt}: info {info}")
            del eng
        check(np.array_equal(rows_by["auto"], rows_by["int8"]),
              "phase 21: the auto engine's rows are not the int8 engine's")
        root = os.path.join(tmp, "classes")
        write_class_folders(root, 4, 16)
        ds = FolderDataset(root)
        px = model.clip_cfg.vision.image_size
        acc = {dt: zero_shot_accuracy(model, tokenizer, HostLoader(
            ds, batch_size=BATCH, num_workers=8, native_n_px=px), ds.class_names, n_px=px,
            dtype=dt) for dt in ("auto", "int8")}
        print(f"phase 21 zero-shot: auto {acc['auto']}, int8 {acc['int8']}")
        check(acc["auto"] == acc["int8"] and acc["auto"]["n"] == 64,
              "phase 21: zero-shot at auto is not the int8 rung's")
        walls["21.4 engine and zero-shot at auto"] = time.perf_counter() - t0

        # 21.5 the CLI at --dtype auto, in a process of its own
        t0 = time.perf_counter()
        vocab = os.path.join(tmp, "bpe_vocab.txt.gz")
        with gzip.open(vocab, "wt", encoding="utf-8") as f:
            f.write("#version: 0.2\nt h\nth e</w>\na </w>\n")
        proc = subprocess.run(
            [sys.executable, "-m", "debias_vision_lang_torch", "measure-bias", "--dtype",
             "auto", "--random-weights", "--data-path", ff, "--batch-size", str(BATCH)],
            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
            timeout=600, env=dict(os.environ, DEBIAS_VLT_BPE_PATH=vocab))
        print(f"phase 21 CLI measure-bias --dtype auto --random-weights: exit "
              f"{proc.returncode} in {time.perf_counter() - t0:.2f} s")
        check(proc.returncode == 0, f"phase 21: the CLI failed: {proc.stderr[-3000:]}")
        res = json.loads(proc.stdout[proc.stdout.index("{"):])
        check(set(res) == {"maxskew", "ndkl"} and all(
            math.isfinite(v) for d in res.values() for v in d.values()),
              f"phase 21: the CLI printed {res}")
        walls["21.5 the CLI"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the kernels line's rows of the new shapes, with the sweep's launches
    for (name, case), row in rows.items():
        d = int(re.search(r"D=(\d+)", case).group(1))
        kind = "text" if "text" in case else ("slip_vit" if "SLIP" in case else "vit")
        row["launches"] = tower_launches.get((name, d, kind))
        check(row["launches"] in (12, 24), f"phase 21 {name} {case}: launches {row['launches']}")
    print(f"phase 21 img/s at B={BATCH}, image towers, CUDA events ({card}):")
    print(f"  {'arch':34s} " + " ".join(f"{r:>10s}" for r in RUNGS) + "  auto picks / fastest")
    if tower_img_s:  # phase 13's ViT-B/16 (the kernels' rungs and plain float32)
        vals = {"float32": tower_img_s["plain float32"],
                "bfloat16": tower_img_s["kernels (bf16)"], "int8": tower_img_s["kernels (int8)"]}
        print(f"  {'openai/CLIP/ViT-B/16 (phase 13)':34s} " + " ".join(
            f"{vals.get(r, float('nan')):10.1f}" for r in RUNGS)
            + f"  int8 / {max(vals, key=vals.get)}")
    for arch, (img_s, auto, fast) in table.items():
        print(f"  {arch:34s} " + " ".join(f"{img_s[r]:10.1f}" for r in RUNGS)
              + f"  {auto} / {fast}" + ("" if auto == fast else "  (the card disagrees)"))
    print("  img/s of the rung auto picks over float32's: " + ", ".join(
        f"{arch} {img_s[auto] / img_s['float32']:.2f}x" for arch, (img_s, auto, _) in table.items()))
    for k, v in walls.items():
        print(f"phase 21 wall {k}: {v:.2f} s ({card})")
    return list(rows.values()), sum(walls.values())


# ---------------------------------------------------------------------------
# phase 22: tensor parallel -- the Megatron head / hidden splits over the
# model axis on virtual meshes of the one card, and KB (a) 6
# ---------------------------------------------------------------------------

# (1, 8): ViT-B/16's 12 image heads in slots of 1 and 2 (JAX splits the
# columns and takes any head count), its 8 text heads one a slot
TP_MESHES = ((1, 2), (2, 2), (1, 4), (1, 8))
# towers of random blocks off the registry splits: (label, D, heads, F,
# activation, layers, mesh, B, S): two heads over four slots (two slots hold
# none and launch no attention), and ViT-H/14's widths (16 heads of 80, the
# padded plan a slot) over two
TP_WIDE = (("H=2 over 4 slots", 128, 2, 512, "quick_gelu", 2, (1, 4), 8, 77),
           ("ViT-H/14 widths", 1280, 16, 5120, "gelu", 2, (1, 2), 8, 257))
TP_F32_ATOL = 1e-4  # float32 TP logits vs unsharded: JAX's bar (tests/test_parallel.py)
TP_COS = 0.99999  # int8 TP tower rows vs unsharded, should they not be bit-equal
# bf16 TP tower rows vs the unsharded bf16 tower.  Every split block sits
# within 1 bf16 ulp of K1 + K2 (the row-parallel sums reorder f32 sums),
# and the random-weight tower amplifies such flips over 12 layers.  The
# drift floor is the same tower with every block on the twins (also within
# 1 ulp per block) against the kernels: the bar is TP_COS_BF16, or where
# that is tighter than the floor, a drift (1 - cosine) at most
# TP_DRIFT_RATIO times the floor's; the floor itself must hold TP_FLOOR_MIN
TP_COS_BF16 = 0.99999
TP_DRIFT_RATIO = 2.0
TP_FLOOR_MIN = 0.9999
# the dryrun step's token gradient vs the unsharded step on the card, of its
# largest magnitude.  The same unsharded step on the CPU differs from the
# card's by 2.55e-5 of it, the split step by 2.17e-5 (both in PERF.md):
# float32's own noise at this width is past 1e-5, so the bar is a fixed 5e-5
TP_GRAD_TOL = 5e-5
TP_LOSS_TOL = 1e-6
TP_F32_B, TP_DRY_B, TP_FIT_B = 16, 8, 8
# the TPU-side lines of the kernels line: KB (a) 6's pallas_call; the head
# group / column entries compute K1-K4's function on a slice; the reduces
# stand for the psum GSPMD inserts after a row-parallel product (JAX's
# clip_param_pspecs, wo row spec)
TP_REPLACES = {
    "attention_block_hgrid": "benchmarks/attn_variants.py:155",
    "attention_block_heads": "debias_vision_lang_tpu/ops/fused_block.py:287",
    "mlp_block_cols": "debias_vision_lang_tpu/ops/fused_block.py:346",
    "tp_reduce": "debias_vision_lang_tpu/parallel/mesh.py:165",
    "attention_block_q_heads": "debias_vision_lang_tpu/ops/fused_block_q.py:336",
    "mlp_block_q_cols": "debias_vision_lang_tpu/ops/fused_block_q.py:403",
    "rows_q_partial": "debias_vision_lang_tpu/ops/fused_block_q.py:336",
    "tp_reduce_q": "debias_vision_lang_tpu/parallel/mesh.py:165",
}


def tp_attention_work(b, s, d, m, causal=False, weights="bf16"):
    """A head group's share (1/m of the heads): its QKV and out products in
    the weights' type, the core on its heads in bf16; x read, the f32 (bf16)
    partial written (int8: the bf16 attention rows and their amax)."""
    mm, dg = b * s, d // m
    pairs = s * (s + 1) / 2 if causal else s * s
    ops = {"bf16": 4 * b * pairs * dg}
    if weights == "int8":
        ops["int8"] = 2 * mm * d * 3 * dg
        return ops, 2 * mm * d + 2 * mm * dg + 4 * mm + 3 * d * dg + 8 * 3 * dg + 8 * d
    ops["bf16"] += 2 * mm * d * 3 * dg + 2 * mm * dg * d
    return ops, 2 * mm * d + 4 * mm * d + 2 * 4 * d * dg + 4 * (3 * dg + 2 * d)


def tp_mlp_work(b, s, d, f, m, weights="bf16"):
    mm, fj = b * s, f // m
    if weights == "int8":  # up to the f32 hidden and its amax
        return {"int8": 2 * mm * d * fj}, 2 * mm * d + 4 * mm * fj + 4 * mm + d * fj + 8 * fj
    return {"bf16": 4 * mm * d * fj}, 2 * mm * d + 4 * mm * d + 2 * 2 * d * fj + 4 * (fj + 2 * d)


def tp_rows_q_work(mm, k, n, m, a_bytes):
    """rows_q_partial: the input [M, K] read, m amaxes, codes and scales
    written, the int8 product into an int32 [M, N] partial."""
    return {"int8": 2 * mm * k * n}, mm * k * a_bytes + 4 * mm * m + mm * k + 4 * mm + k * n \
        + 4 * mm * n


def tp_reduce_work(mm, n, m, part_bytes=4, extra=0):
    return {}, m * part_bytes * mm * n + 2 * 2 * mm * n + 4 * n + extra


def compare_part(name, got, ref):
    """An f32 partial against its twin's: within 1 bf16 ulp of the twin's
    largest magnitude (the kernels' bar)."""
    err = (got.float() - ref.float()).abs().max().item()
    tol = ulp_bf16(ref.float().abs().max().item())
    print(f"kernel {name}: max_abs_err {err} (tolerance {tol} = 1 bf16 ulp of max |twin|)")
    check(math.isfinite(err) and err <= tol, f"{name}: kernel disagrees with its twin")
    return err


def hgrid_operands(attn, heads):
    """KB (a) 6's operands from a block's (ln_s, ln_b, wqkv, bqkv, wo, bo)
    (``benchmarks_torch/tp_slot_split.py::hgrid_operands``)."""
    from benchmarks_torch.tp_slot_split import hgrid_operands as build

    return build(attn, heads)


def group_slice(attn, mlp, d, m, j, heads=None):
    """Slot j of m's head group (``parallel/tensor.head_group``: uneven where
    m does not divide the heads; head dim 64 when ``heads`` is None) and
    hidden columns of a block's tensors."""
    from debias_vision_lang_torch.parallel.tensor import head_columns, head_group

    ls, lb, wqkv, bqkv, wo, _ = attn
    l2s, l2b, w1, b1, w2, _ = mlp
    f = w1.shape[1]
    heads = d // 64 if heads is None else heads
    cols = head_columns(d, m, j, heads).to(wqkv.device)
    lo, hi = head_group(heads, m, j)
    hd = d // heads
    rows, hid = slice(lo * hd, hi * hd), slice(j * f // m, (j + 1) * f // m)
    return ((ls, lb, wqkv[:, cols], bqkv[cols], wo[rows]),
            (l2s, l2b, w1[:, hid], b1[hid], w2[hid]))


def tp_kernels(fb, fbq, device, card):
    """Phase 22's kernel checks: every split entry against its twin at the
    main path's shapes, with the residual at x and x/16; timed ones become
    kernels-line rows (launches set by the caller)."""
    import torch
    from debias_vision_lang_torch.parallel.tensor import head_columns, head_group

    rows = {}
    g_in = torch.Generator().manual_seed(22)
    d, heads, b, s = 768, 12, BATCH, 197
    attn, mlp = block_params(d, device, seed=7)
    kb = hgrid_operands(attn, heads)
    for scale in (1.0, 1 / 16):
        x = (torch.randn(b, s, d, generator=g_in) * scale).to(device, torch.bfloat16)
        tag = f"B={b} S={s} D={d} x~N(0,{scale}^2)"
        for g in (12, 6, 3):
            m = heads // g
            ga, gm = group_slice(attn, mlp, d, m, m - 1)
            compare_part(f"attention_block_heads {tag} g={g} (slot {m - 1} of {m})",
                         fb.attention_block_heads(x, *ga, heads=g),
                         fb.attention_block_heads_plain(x, *ga, heads=g))
            h0 = heads - g
            got = fb.attention_block_hgrid(x, *kb, heads=heads, h0=h0, g=g)
            ref = fb.attention_block_hgrid_plain(x, *kb, heads=heads, h0=h0, g=g)
            if g == heads:
                compare_bf16(f"attention_block_hgrid {tag} (KB (a) 6)", x, got, ref)
            else:
                compare_part(f"attention_block_hgrid {tag} heads [{h0}, {heads})", got, ref)
        for m in (2, 4):
            ga, gm = group_slice(attn, mlp, d, m, m - 1)
            compare_part(f"mlp_block_cols {tag} F/m={4 * d // m}",
                         fb.mlp_block_cols(x, *gm), fb.mlp_block_cols_plain(x, *gm))
        # the four head groups' partials reduced: the twin's sum bit for bit,
        # and K1's block within 1 ulp
        parts = [fb.attention_block_heads(x, *group_slice(attn, mlp, d, 4, j)[0], heads=3)
                 for j in range(4)]
        red = fb.tp_reduce(parts, attn[5], x, bias_first=False)
        same = torch.equal(red, fb.tp_reduce_plain(parts, attn[5], x, bias_first=False))
        print(f"kernel tp_reduce {tag} m=4: {'bit-equal to' if same else 'differs from'} "
              f"its twin on the kernels' partials")
        check(same, "tp_reduce: the f32 sum differs from its twin's")
        compare_bf16(f"tp_reduce of 4 head groups vs K1 {tag}", x, red,
                     fb.attention_block(x, *attn, heads=heads))
    # the text tower's causal shape, and the long core
    attn_t, mlp_t = block_params(512, device, seed=11)
    xt = torch.randn(319, 77, 512, generator=g_in).to(device, torch.bfloat16)
    for g in (4, 2):
        ga, _ = group_slice(attn_t, mlp_t, 512, 8 // g, 0)
        compare_part(f"attention_block_heads B=319 S=77 D=512 causal g={g}",
                     fb.attention_block_heads(xt, *ga, heads=g, causal=True),
                     fb.attention_block_heads_plain(xt, *ga, heads=g, causal=True))
    attn_l, mlp_l = block_params(768, device, seed=FIT_JOINT_S)
    kb_l = hgrid_operands(attn_l, 12)
    xl = torch.randn(8, FIT_JOINT_S, 768, generator=g_in).to(device, torch.bfloat16)
    fb.reset_launches()
    ga, _ = group_slice(attn_l, mlp_l, 768, 2, 1)
    compare_part(f"attention_block_heads B=8 S={FIT_JOINT_S} g=6 (long core)",
                 fb.attention_block_heads(xl, *ga, heads=6),
                 fb.attention_block_heads_plain(xl, *ga, heads=6))
    compare_part(f"attention_block_hgrid B=8 S={FIT_JOINT_S} heads [6, 12) (long core)",
                 fb.attention_block_hgrid(xl, *kb_l, heads=12, h0=6, g=6),
                 fb.attention_block_hgrid_plain(xl, *kb_l, heads=12, h0=6, g=6))
    compare_bf16(f"attention_block_hgrid B=8 S={FIT_JOINT_S} (KB (a) 6, long core)", xl,
                 fb.attention_block_hgrid(xl, *kb_l, heads=12),
                 fb.attention_block_hgrid_plain(xl, *kb_l, heads=12))
    check(fb.CORE_ROUTES == {"short": 0, "long": 3}, f"phase 22: long core routes {fb.CORE_ROUTES}")
    del xl, xt

    # int8: each slot's attention rows and hidden are K3's / K4's own columns
    # bit for bit, its codes the twin's quantizer at the row's global amax
    # on those rows, its int32 partial the twin's, exactly
    (qa, qakw), (qm, qmkw) = q_block_params(d, device, seed=7)
    x = torch.randn(b, s, d, generator=g_in).to(device, torch.bfloat16)
    sk3, sk4 = {}, {}
    want3 = fbq.attention_block_q(x, *qa, heads=heads, **qakw, scratch=sk3)
    want4 = fbq.mlp_block_q(x, *qm, **qmkw, scratch=sk4)
    hd = d // heads
    for m in (2, 4, 8):  # at m = 8 slots of 1 and 2 heads
        outs, hs, groups = [], [], []
        for j in range(m):
            lo, hi = head_group(heads, m, j)
            g = hi - lo
            groups.append(slice(lo * hd, hi * hd))
            cols = head_columns(d, m, j, heads).to(device)
            wq_q, wq_s = qa[2][:, cols], qa[3][:, cols]
            attn_j, amax_j = fbq.attention_block_q_heads(
                x, qa[0], qa[1], wq_q, wq_s, qa[4][cols], heads=g,
                wqkv_qt=wq_q.t().contiguous())
            check(torch.equal(amax_j, fbq.row_amax(attn_j)),
                  f"attention_block_q_heads m={m} slot {j}: amax is not its rows'")
            check(torch.equal(attn_j.float(), sk3["attn"][..., groups[-1]]),
                  f"attention_block_q_heads m={m} slot {j}: rows are not K3's")
            ref_attn, _ = fbq.attention_block_q_heads_plain(x, qa[0], qa[1], wq_q, wq_s,
                                                            qa[4][cols], heads=g)
            err = (attn_j.float() - ref_attn.float()).abs().max().item()
            tol = ulp_bf16(ref_attn.float().abs().max().item())
            check(err <= tol, f"attention_block_q_heads m={m} slot {j}: rows off by {err}")
            outs.append(attn_j)
            hid = slice(j * 4 * d // m, (j + 1) * 4 * d // m)
            w1_q, w1_s = qm[2][:, hid], qm[3][:, hid]
            h_j, hmax_j = fbq.mlp_block_q_cols(x, qm[0], qm[1], w1_q, w1_s, qm[4][hid],
                                               w1_qt=w1_q.t().contiguous())
            check(torch.equal(hmax_j, fbq.row_amax(h_j)) and torch.equal(h_j, sk4["h"][..., hid]),
                  f"mlp_block_q_cols m={m} slot {j}: the hidden is not K4's or its amax")
            hs.append(h_j)
        amaxes = [fbq.row_amax(o) for o in outs]
        parts, parts_ref = [], []
        for j, a_j in enumerate(outs):
            wo_q = qa[5][groups[j]]
            acc, aq, sc = fbq.rows_q_partial(a_j, amaxes, wo_q, w_qt=wo_q.t().contiguous())
            acc2, aq2, sc2 = fbq.rows_q_partial_plain(a_j, amaxes, wo_q)
            check(torch.equal(aq, aq2) and torch.equal(sc, sc2) and torch.equal(acc, acc2),
                  f"rows_q_partial m={m} slot {j}: codes or int32 partial differ from the twin's")
            parts.append(acc)
        out = fbq.tp_reduce_q(parts, sc, qa[6], qa[7], x, bias_first=False)
        check(torch.equal(out, fbq.tp_reduce_q_plain(parts, sc, qa[6], qa[7], x,
                                                     bias_first=False)),
              f"tp_reduce_q m={m}: differs from its twin")
        want = want3
        print(f"kernel attention_block_q_heads + rows_q_partial + tp_reduce_q B={b} S={s} m={m}: "
              f"rows K3's, codes and int32 partials the twin's; the reduced block "
              f"{'bit-equal to' if torch.equal(out, want) else 'differs from'} K3")
        check(torch.equal(out, want), f"int8 split attention m={m} is not K3's block")
        hmax = [fbq.row_amax(h) for h in hs]
        parts = []
        for j, h_j in enumerate(hs):
            w2_q = qm[5][j * 4 * d // m:(j + 1) * 4 * d // m]
            acc, _, hsc = fbq.rows_q_partial(h_j, hmax, w2_q, w_qt=w2_q.t().contiguous())
            parts.append(acc)
        out = fbq.tp_reduce_q(parts, hsc, qm[6], qm[7], x, bias_first=True)
        want = want4
        print(f"kernel mlp_block_q_cols + rows_q_partial + tp_reduce_q B={b} S={s} m={m}: the "
              f"reduced block {'bit-equal to' if torch.equal(out, want) else 'differs from'} K4")
        check(torch.equal(out, want), f"int8 split MLP m={m} is not K4's block")
    torch.cuda.synchronize()

    # timed at B=256 (m = 2; KB (a) 6 whole, beside K1)
    def row(name, lib, err, kern, plain, work, iters=5, key=None, what=""):
        r = kernel_row(name, f"ViT-B/16 B={b} S={s} D={d} m=2{what}", lib, 0, err,
                       cuda_ms(kern, iters=iters), cuda_ms(plain, iters=2), work)
        r["replaces"] = TP_REPLACES[name]
        rows[key or name] = r
        print(f"time {key or name} {r['case']}: kernel {r['ms']:.4f} ms, plain twin "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}; the "
              f"kernel at {r['bound_ms'] / r['ms']:.1%} of it) ({card})")

    ga, gm = group_slice(attn, mlp, d, 2, 0)
    k1_ms = cuda_ms(lambda: fb.attention_block(x, *attn, heads=heads))
    row("attention_block_hgrid", "fused_block",
        compare_bf16("attention_block_hgrid (timed)", x,
                     fb.attention_block_hgrid(x, *kb, heads=heads),
                     fb.attention_block_hgrid_plain(x, *kb, heads=heads)),
        lambda: fb.attention_block_hgrid(x, *kb, heads=heads),
        lambda: fb.attention_block_hgrid_plain(x, *kb, heads=heads),
        attention_block_work(b, s, d))
    rows["attention_block_hgrid"]["case"] = f"KB (a) 6, ViT-B/16 B={b} S={s} D={d} H=12"
    print(f"time attention_block_hgrid beside K1 (attention_block) on the same x: "
          f"{rows['attention_block_hgrid']['ms']:.4f} vs {k1_ms:.4f} ms ({card})")
    p_ref = fb.attention_block_heads_plain(x, *ga, heads=6)
    row("attention_block_heads", "fused_block",
        compare_part("attention_block_heads (timed)", fb.attention_block_heads(x, *ga, heads=6),
                     p_ref),
        lambda: fb.attention_block_heads(x, *ga, heads=6),
        lambda: fb.attention_block_heads_plain(x, *ga, heads=6), tp_attention_work(b, s, d, 2))
    row("mlp_block_cols", "fused_block",
        compare_part("mlp_block_cols (timed)", fb.mlp_block_cols(x, *gm),
                     fb.mlp_block_cols_plain(x, *gm)),
        lambda: fb.mlp_block_cols(x, *gm), lambda: fb.mlp_block_cols_plain(x, *gm),
        tp_mlp_work(b, s, d, 4 * d, 2))
    parts2 = [p_ref, p_ref.clone()]
    row("tp_reduce", "fused_block",
        compare_bf16("tp_reduce (timed)", x, fb.tp_reduce(parts2, attn[5], x, bias_first=False),
                     fb.tp_reduce_plain(parts2, attn[5], x, bias_first=False)),
        lambda: fb.tp_reduce(parts2, attn[5], x, bias_first=False),
        lambda: fb.tp_reduce_plain(parts2, attn[5], x, bias_first=False),
        tp_reduce_work(b * s, d, 2))
    cols = head_columns(d, 2, 0, heads).to(device)
    wq_q, wq_s, wq_t = qa[2][:, cols], qa[3][:, cols], qa[2][:, cols].t().contiguous()
    a0, m0 = fbq.attention_block_q_heads(x, qa[0], qa[1], wq_q, wq_s, qa[4][cols], heads=6,
                                         wqkv_qt=wq_t)
    r0, _ = fbq.attention_block_q_heads_plain(x, qa[0], qa[1], wq_q, wq_s, qa[4][cols], heads=6)
    row("attention_block_q_heads", "fused_block_q",
        (a0.float() - r0.float()).abs().max().item(),
        lambda: fbq.attention_block_q_heads(x, qa[0], qa[1], wq_q, wq_s, qa[4][cols], heads=6,
                                            wqkv_qt=wq_t),
        lambda: fbq.attention_block_q_heads_plain(x, qa[0], qa[1], wq_q, wq_s, qa[4][cols],
                                                  heads=6),
        tp_attention_work(b, s, d, 2, weights="int8"))
    w1_q, w1_s, w1_t = qm[2][:, :2 * d], qm[3][:, :2 * d], qm[2][:, :2 * d].t().contiguous()
    h0, _ = fbq.mlp_block_q_cols(x, qm[0], qm[1], w1_q, w1_s, qm[4][:2 * d], w1_qt=w1_t)
    # the twin's up-projection on the kernel's own codes (K4's, which phase
    # 6 holds to the twin's quantizer): the epilogue's f32 rounding only
    h_own = fb._act(fbq.dot_q(sk4["xq"], sk4["xs"], w1_q, w1_s) + qm[4][:2 * d].float(),
                    "quick_gelu")
    h_err = (h0 - h_own).abs().max().item()
    print(f"kernel mlp_block_q_cols (timed): hidden vs the twin on its own codes max |diff| "
          f"{h_err} (bar 1e-5 of max {h_own.abs().max().item()})")
    check(h_err <= 1e-5 * h_own.abs().max().item(), "mlp_block_q_cols: hidden off the twin's")
    row("mlp_block_q_cols", "fused_block_q", h_err,
        lambda: fbq.mlp_block_q_cols(x, qm[0], qm[1], w1_q, w1_s, qm[4][:2 * d], w1_qt=w1_t),
        lambda: fbq.mlp_block_q_cols_plain(x, qm[0], qm[1], w1_q, w1_s, qm[4][:2 * d]),
        tp_mlp_work(b, s, d, 4 * d, 2, weights="int8"))
    wo_q = qa[5][:d // 2]
    wo_t = wo_q.t().contiguous()
    got, want = (fbq.rows_q_partial(a0, [m0, m0], wo_q, w_qt=wo_t),
                 fbq.rows_q_partial_plain(a0, [m0, m0], wo_q))
    rq_err = (got[0] - want[0]).abs().max().item()
    print(f"kernel rows_q_partial (timed): codes, row scales and int32 partial "
          f"{'equal to' if all(map(torch.equal, got, want)) else 'differ from'} the twin's; "
          f"int32 max |diff| {rq_err}")
    check(all(map(torch.equal, got, want)), "rows_q_partial (timed): differs from its twin")
    row("rows_q_partial", "fused_block_q", rq_err,
        lambda: fbq.rows_q_partial(a0, [m0, m0], wo_q, w_qt=wo_t),
        lambda: fbq.rows_q_partial_plain(a0, [m0, m0], wo_q),
        tp_rows_q_work(b * s, d // 2, d, 2, 2), what=", attention K=384 bf16")
    # the MLP half's: slot 0's f32 hidden (Fj = 1,536) at both slots' amaxes
    w1_q1, w1_s1 = qm[2][:, 2 * d:], qm[3][:, 2 * d:]
    _, hm1 = fbq.mlp_block_q_cols(x, qm[0], qm[1], w1_q1, w1_s1, qm[4][2 * d:],
                                  w1_qt=w1_q1.t().contiguous())
    w2_q, w2_t = qm[5][:2 * d], qm[5][:2 * d].t().contiguous()
    hams = [fbq.row_amax(h0), hm1]
    got, want = (fbq.rows_q_partial(h0, hams, w2_q, w_qt=w2_t),
                 fbq.rows_q_partial_plain(h0, hams, w2_q))
    check(all(map(torch.equal, got, want)), "rows_q_partial (MLP, timed): differs from its twin")
    row("rows_q_partial", "fused_block_q", 0.0,
        lambda: fbq.rows_q_partial(h0, hams, w2_q, w_qt=w2_t),
        lambda: fbq.rows_q_partial_plain(h0, hams, w2_q),
        tp_rows_q_work(b * s, 2 * d, d, 2, 4), key="rows_q_partial mlp", what=", MLP K=1536 f32")
    del got, want
    acc0, _, sc0 = fbq.rows_q_partial(a0, [m0], wo_q, w_qt=wo_t)
    pq = [acc0, acc0.clone()]
    got = fbq.tp_reduce_q(pq, sc0, qa[6], qa[7], x, bias_first=False)
    want = fbq.tp_reduce_q_plain(pq, sc0, qa[6], qa[7], x, bias_first=False)
    rd_err = (got.float() - want.float()).abs().max().item()
    same = torch.equal(got, want)
    print(f"kernel tp_reduce_q (timed): {'bit-equal to' if same else 'differs from'} the twin; "
          f"max |diff| {rd_err}")
    check(same, "tp_reduce_q (timed): differs from its twin")
    row("tp_reduce_q", "fused_block_q", rd_err,
        lambda: fbq.tp_reduce_q(pq, sc0, qa[6], qa[7], x, bias_first=False),
        lambda: fbq.tp_reduce_q_plain(pq, sc0, qa[6], qa[7], x, bias_first=False),
        tp_reduce_work(b * s, d, 2, extra=4 * b * s + 4 * d))
    tp8_rows(fb, fbq, rows, x, attn, mlp, qa, qm, sk4, card)
    # each bf16 slot row names the route its calls take (fused_block.slot_route),
    # each rows_q_partial row its own (fused_block_q.rows_route)
    for key, r in rows.items():
        if r["name"] == "rows_q_partial":
            k = int(r["case"].split(" K=")[1].split()[0])
            r["case"] += f", {fbq.rows_route(k, d)} route"
        if r["name"] == "attention_block_heads":
            g = 6 if key == "attention_block_heads" else int(key.split("g=")[1].split()[0])
            r["case"] += f", {fb.slot_route(fb.group_plan(d, d // heads, g).da, d)} route"
        elif r["name"] == "mlp_block_cols":
            route = fb.slot_route(fb.mlp_plan(d, 4 * d // (2 if key == "mlp_block_cols" else 8)).fp, d)
            r["case"] += f", {route} route"
    del x
    torch.cuda.empty_cache()
    return rows, k1_ms


# the kernels-line rows of the (1, 8) split: (row key, kernel)
TP8 = (("attention_block_heads g=2 m=8", "attention_block_heads"),
       ("attention_block_heads g=1 m=8", "attention_block_heads"),
       ("mlp_block_cols m=8", "mlp_block_cols"), ("tp_reduce m=8", "tp_reduce"),
       ("attention_block_q_heads g=2 m=8", "attention_block_q_heads"),
       ("attention_block_q_heads g=1 m=8", "attention_block_q_heads"),
       ("mlp_block_q_cols m=8", "mlp_block_q_cols"), ("rows_q_partial m=8", "rows_q_partial"),
       ("rows_q_partial mlp m=8", "rows_q_partial"), ("tp_reduce_q m=8", "tp_reduce_q"))
# the rows_q_partial rows' launches come from ``fused_block_q.ROWS_INPUTS``: the
# attention half's bf16 rows, the MLP half's f32 hidden
TP_ROWS_INPUT = {"rows_q_partial": "bf16", "rows_q_partial mlp": "f32",
                 "rows_q_partial m=8": "bf16", "rows_q_partial mlp m=8": "f32"}


def tp8_rows(fb, fbq, rows, x, attn, mlp, qa, qm, sk4, card):
    """ViT-B/16's split over 8 slots (slots of 2 and 1 of its 12 heads, 384
    hidden columns each) timed at the main path's B=256 against their twins
    (the partials within 1 bf16 ulp, the int8 pieces bit for bit): the
    kernels-line rows TP8 (launches set by the (1, 8) tower run)."""
    import torch
    from debias_vision_lang_torch.parallel.tensor import head_columns, head_group

    b, s, d = x.shape
    heads, m, f = 12, 8, 4 * d
    fj = f // m

    def row(key, name, lib, err, kern, plain, work, iters=5, what=""):
        split = key[len(name) + 1:].replace("mlp ", "")
        r = kernel_row(name, f"ViT-B/16 B={b} S={s} D={d} {split}{what}", lib, 0, err,
                       cuda_ms(kern, iters=iters), cuda_ms(plain, iters=2), work)
        r["replaces"] = TP_REPLACES[name]
        rows[key] = r
        print(f"time {key} {r['case']}: kernel {r['ms']:.4f} ms, plain twin "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}; the "
              f"kernel at {r['bound_ms'] / r['ms']:.1%} of it) ({card})")

    parts = []
    for j in range(m):
        ga, _ = group_slice(attn, mlp, d, m, j, heads)
        g = head_group(heads, m, j)[1] - head_group(heads, m, j)[0]
        parts.append(fb.attention_block_heads(x, *ga, heads=g))
        if j in (0, 1):
            ref = fb.attention_block_heads_plain(x, *ga, heads=g)
            row(f"attention_block_heads g={g} m=8", "attention_block_heads", "fused_block",
                compare_part(f"attention_block_heads m=8 slot {j} ({g} heads)", parts[-1], ref),
                lambda: fb.attention_block_heads(x, *ga, heads=g),
                lambda: fb.attention_block_heads_plain(x, *ga, heads=g),
                tp_attention_work(b, s, d, heads // g))
    red = fb.tp_reduce(parts, attn[5], x, bias_first=False)
    check(torch.equal(red, fb.tp_reduce_plain(parts, attn[5], x, bias_first=False)),
          "tp_reduce m=8: the f32 sum differs from its twin's")
    row("tp_reduce m=8", "tp_reduce", "fused_block",
        compare_bf16("tp_reduce of 8 uneven head groups vs K1", x, red,
                     fb.attention_block(x, *attn, heads=heads)),
        lambda: fb.tp_reduce(parts, attn[5], x, bias_first=False),
        lambda: fb.tp_reduce_plain(parts, attn[5], x, bias_first=False),
        tp_reduce_work(b * s, d, m))
    del parts
    _, gm = group_slice(attn, mlp, d, m, 3, heads)
    row("mlp_block_cols m=8", "mlp_block_cols", "fused_block",
        compare_part(f"mlp_block_cols m=8 F/m={fj}", fb.mlp_block_cols(x, *gm),
                     fb.mlp_block_cols_plain(x, *gm)),
        lambda: fb.mlp_block_cols(x, *gm), lambda: fb.mlp_block_cols_plain(x, *gm),
        tp_mlp_work(b, s, d, f, m))
    # int8: slot 1 (heads 1 and 2), its partial on the global amax
    cols = head_columns(d, m, 1, heads).to(x.device)
    wq_q, wq_s, wq_t = qa[2][:, cols], qa[3][:, cols], qa[2][:, cols].t().contiguous()
    a1, m1 = fbq.attention_block_q_heads(x, qa[0], qa[1], wq_q, wq_s, qa[4][cols], heads=2,
                                         wqkv_qt=wq_t)
    r1, _ = fbq.attention_block_q_heads_plain(x, qa[0], qa[1], wq_q, wq_s, qa[4][cols], heads=2)
    row("attention_block_q_heads g=2 m=8", "attention_block_q_heads", "fused_block_q",
        (a1.float() - r1.float()).abs().max().item(),
        lambda: fbq.attention_block_q_heads(x, qa[0], qa[1], wq_q, wq_s, qa[4][cols], heads=2,
                                            wqkv_qt=wq_t),
        lambda: fbq.attention_block_q_heads_plain(x, qa[0], qa[1], wq_q, wq_s, qa[4][cols],
                                                  heads=2),
        tp_attention_work(b, s, d, 6, weights="int8"))
    # slot 0 (head 0)
    cols0 = head_columns(d, m, 0, heads).to(x.device)
    wq0_q, wq0_s, wq0_t = qa[2][:, cols0], qa[3][:, cols0], qa[2][:, cols0].t().contiguous()
    a0, _ = fbq.attention_block_q_heads(x, qa[0], qa[1], wq0_q, wq0_s, qa[4][cols0], heads=1,
                                        wqkv_qt=wq0_t)
    r0, _ = fbq.attention_block_q_heads_plain(x, qa[0], qa[1], wq0_q, wq0_s, qa[4][cols0],
                                              heads=1)
    row("attention_block_q_heads g=1 m=8", "attention_block_q_heads", "fused_block_q",
        (a0.float() - r0.float()).abs().max().item(),
        lambda: fbq.attention_block_q_heads(x, qa[0], qa[1], wq0_q, wq0_s, qa[4][cols0], heads=1,
                                            wqkv_qt=wq0_t),
        lambda: fbq.attention_block_q_heads_plain(x, qa[0], qa[1], wq0_q, wq0_s, qa[4][cols0],
                                                  heads=1),
        tp_attention_work(b, s, d, 12, weights="int8"))
    del a0, r0
    hid = slice(3 * fj, 4 * fj)
    w1_q, w1_s, w1_t = qm[2][:, hid], qm[3][:, hid], qm[2][:, hid].t().contiguous()
    h3, hm3 = fbq.mlp_block_q_cols(x, qm[0], qm[1], w1_q, w1_s, qm[4][hid], w1_qt=w1_t)
    check(torch.equal(h3, sk4["h"][..., hid]) and torch.equal(hm3, fbq.row_amax(h3)),
          "mlp_block_q_cols m=8: the hidden is not K4's or its amax")
    row("mlp_block_q_cols m=8", "mlp_block_q_cols", "fused_block_q", 0.0,
        lambda: fbq.mlp_block_q_cols(x, qm[0], qm[1], w1_q, w1_s, qm[4][hid], w1_qt=w1_t),
        lambda: fbq.mlp_block_q_cols_plain(x, qm[0], qm[1], w1_q, w1_s, qm[4][hid]),
        tp_mlp_work(b, s, d, f, m, weights="int8"))
    wo_q = qa[5][64:192]
    wo_t = wo_q.t().contiguous()
    ams = [m1] * m
    got, want = (fbq.rows_q_partial(a1, ams, wo_q, w_qt=wo_t),
                 fbq.rows_q_partial_plain(a1, ams, wo_q))
    check(all(map(torch.equal, got, want)), "rows_q_partial m=8: differs from its twin")
    row("rows_q_partial m=8", "rows_q_partial", "fused_block_q", 0.0,
        lambda: fbq.rows_q_partial(a1, ams, wo_q, w_qt=wo_t),
        lambda: fbq.rows_q_partial_plain(a1, ams, wo_q), tp_rows_q_work(b * s, 128, d, m, 2),
        what=", attention K=128 bf16")

    ams3 = [hm3] * m
    w2_q, w2_t = qm[5][hid], qm[5][hid].t().contiguous()
    hgot, hwant = (fbq.rows_q_partial(h3, ams3, w2_q, w_qt=w2_t),
                   fbq.rows_q_partial_plain(h3, ams3, w2_q))
    check(all(map(torch.equal, hgot, hwant)), "rows_q_partial MLP m=8: differs from its twin")
    row("rows_q_partial mlp m=8", "rows_q_partial", "fused_block_q", 0.0,
        lambda: fbq.rows_q_partial(h3, ams3, w2_q, w_qt=w2_t),
        lambda: fbq.rows_q_partial_plain(h3, ams3, w2_q), tp_rows_q_work(b * s, fj, d, m, 4),
        what=", MLP K=384 f32")
    del hgot, hwant
    pq = [got[0].clone() for _ in range(m)]  # 8 partials, each read once
    out = fbq.tp_reduce_q(pq, got[2], qa[6], qa[7], x, bias_first=False)
    check(torch.equal(out, fbq.tp_reduce_q_plain(pq, got[2], qa[6], qa[7], x, bias_first=False)),
          "tp_reduce_q m=8: differs from its twin")
    row("tp_reduce_q m=8", "tp_reduce_q", "fused_block_q", 0.0,
        lambda: fbq.tp_reduce_q(pq, got[2], qa[6], qa[7], x, bias_first=False),
        lambda: fbq.tp_reduce_q_plain(pq, got[2], qa[6], qa[7], x, bias_first=False),
        tp_reduce_work(b * s, d, m, extra=4 * b * s + 4 * d))


# the int8 slot entries' design before their redesign (one kernel a step:
# LayerNorm, quantize, the GEMM, the core, a block-a-row amax), as
# ``benchmarks_torch/tp_slot_split.py --dump`` recorded it on an NVIDIA H100
# 80GB HBM3: the digests of every slot output and of K3's and K4's on that
# script's inputs, and of the SASS of each kernel of the int8 library (the
# quantize passes' entries taken anew when their amaxes came to propagate
# a NaN)
TP_SLOT_PARENT = "benchmarks_torch/tp_slot_parent.json"
# the kernels of that library this design no longer has: the amax pass it
# rewrote (row_amax_kernel<bf16>, <float>) and rows_q_partial's block-a-row
# quantize pass (quant_rows_given_amax_kernel<bf16>, <float>), which became
# a warp-a-row pass taking a row count (so another mangled name)
TP_SLOT_REPLACED = ("15row_amax_kernelI13__nv_bfloat16EEvPKT_Pfi", "15row_amax_kernelIfEEvPKT_Pfi",
                    "28quant_rows_given_amax_kernelI13__nv_bfloat16EEvPKT_NS_6TpPtrsEiPaPfi",
                    "28quant_rows_given_amax_kernelIfEEvPKT_NS_6TpPtrsEiPaPfi")
# rows_q_partial's design before its redesign (the block-a-row quantize pass,
# then the s8 GEMM writing raw int32), recorded with ``tp_slot_split.py --rows
# --root`` on the parent checkout: the codes, row scales and int32 partials of
# every case a tower runs, the int8 library's SASS.  The redesign adds the
# row-strip kernel and the warp-a-row pass and drops the block-a-row pass;
# every other kernel keeps its SASS.
TP_ROWS_PARENT = "benchmarks_torch/tp_rows_parent.json"
TP_ROWS_NEW = ("rows_strip_q_kernel", "quant_rows_given_amax_kernel")
# the bf16 slot entries' design before theirs (LayerNorm, K1 / K2's GEMMs
# with the f32 epilogue EPI_F32, the core), recorded the same way with
# ``--bf16``: the slot partials, K1's, K2's and KB (a) 6's outputs, the bf16
# library's SASS.  The redesign adds the row-strip kernel and changes no
# other kernel.
TP_SLOT_BF16_PARENT = "benchmarks_torch/tp_slot_bf16_parent.json"
TP_SLOT_BF16_NEW = ("gemm_strip_f32_kernel",)


def tp_slot_split(lib, device, bf16=False):
    """The slot entries held to the design before them, in ``tp_slot_split.py``'s
    cases (ViT-B/16 B=256 at m = 2 and 8, the causal text tower B=319 at m =
    2 and 8; their times are that script's), the int8 ones (``lib``
    fused_block_q) or with ``bf16`` the bf16 ones (fused_block): every output
    bit-identical to its digest there (K3's and K4's, or K1's, K2's and KB
    (a) 6's, too), and every kernel of the library compiled to the same SASS
    but the passes the int8 designs rewrote (TP_SLOT_REPLACED); the bf16
    design only adds its own kernels (TP_SLOT_BF16_NEW).  The int8 library's
    also holds ``rows_q_partial`` to its parent design (``tp_rows_split``)."""
    import importlib

    from debias_vision_lang_torch.ops import _build

    S = importlib.import_module("benchmarks_torch.tp_slot_split")
    where = TP_SLOT_BF16_PARENT if bf16 else TP_SLOT_PARENT
    kind = "fused_block" if bf16 else "fused_block_q"
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), where)) as fh:
        parent = json.load(fh)
    path = _build.LIB_PATHS[kind]
    mine = {"outputs": S.output_digests(lib, S.CASES, device, bf16=bf16),
            "sass": S.sass_digests(path, sass_dump(path))}
    found = bool(mine["sass"])
    if not found:
        print(f"phase 22: no cuobjdump found: the {kind} library's kernels are not held to the "
              f"parent design's SASS")
        mine["sass"] = parent["sass"]
    bad = S.compare(mine, parent, f"the parent design ({where})", "phase 22 ", kind)
    removed = set(parent["sass"]) - set(mine["sass"])
    added = set(mine["sass"]) - set(parent["sass"])
    check(not bad, f"phase 22: {bad} slot outputs or {kind} kernels differ from the parent design")
    check(all(k.endswith(TP_SLOT_REPLACED) for k in removed) if not bf16 else not removed,
          f"phase 22: kernels of the parent's {kind} library are gone: {sorted(removed)}")
    if bf16 and mine["sass"] is not parent["sass"]:
        check(added and all(any(n in k for n in TP_SLOT_BF16_NEW) for k in added),
              f"phase 22: the bf16 library's new kernels {sorted(added)} are not the slot "
              f"design's {TP_SLOT_BF16_NEW}")
    if not bf16:
        tp_rows_split(S, lib, device, mine["sass"] if found else None)


def tp_rows_split(S, fbq, device, sass):
    """``rows_q_partial`` in every case a tower runs (``tp_slot_split.py
    --rows``'s cases; their times are that script's and the kernels line's)
    held to TP_ROWS_PARENT: every code, row scale and int32 partial bit for
    bit; of the int8 library's kernels only the block-a-row quantize pass
    gone, only TP_ROWS_NEW added, none compiled otherwise."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), TP_ROWS_PARENT)) as fh:
        parent = json.load(fh)
    sass = parent["sass"] if sass is None else sass  # no cuobjdump: not held
    mine = {"outputs": S.rows_split(fbq, device, "", "phase 22 split rows "), "sass": sass}
    bad = S.compare(mine, parent, f"the parent design ({TP_ROWS_PARENT})", "phase 22 rows ",
                    "fused_block_q")
    removed = set(parent["sass"]) - set(sass)
    added = set(sass) - set(parent["sass"])
    print(f"phase 22 rows: the parent's quantize pass quant_rows_given_amax_kernel (a block a row) "
          f"is now a warp-a-row pass with a row count, and dvl_rows_q_partial takes the route "
          f"(the row-strip kernel where rows_strip_fits); removed {sorted(removed)}")
    check(not bad, f"phase 22: {bad} rows_q_partial outputs or int8 kernels differ from the "
                   f"parent design")
    check(all("quant_rows_given_amax_kernel" in k for k in removed),
          f"phase 22: kernels of the parent's int8 library are gone: {sorted(removed)}")
    check(all(any(n in k for n in TP_ROWS_NEW + LAYER_NEW + MLP_Q_NEW + VAR_NEW) for k in added),
          f"phase 22: the int8 library's new kernels {sorted(added)} are not "
          f"{TP_ROWS_NEW + LAYER_NEW + MLP_Q_NEW + VAR_NEW}")


def tp_route_check(fb, fbq, device):
    """The bf16 slot entries on their routes (``fused_block.slot_route``) at
    the shapes phase 22 holds them at: each head group's partial and each
    hidden-column slot's equal to the GEMM route's (the parent design's
    kernels, whose SASS ``tp_slot_split`` holds) bit for bit, at D = 768
    (head groups of 6, 3, 2, 1; Fj = 384, 768, 256), the causal D = 512 text
    shape, D = 200 (padded plans, a ragged N edge) and 203 (an odd one: the
    GEMM route; its f32 rows are no whole 16-byte TMA units),
    the long core at S = 785, both activations; each call counted on its
    route.  Then the int8 row-parallel product's two routes
    (``tp_rows_route_check``)."""
    import torch
    from debias_vision_lang_torch.parallel.tensor import head_columns, head_group

    g_in = torch.Generator().manual_seed(26)
    cases = ((768, 12, 8, 197, False, (2, 4, 6, 12), (8, 4, 12), "quick_gelu"),
             (512, 8, 8, 77, True, (2, 8), (8,), "quick_gelu"),
             (200, 2, 4, 77, False, (2,), (4,), "quick_gelu"),
             (203, 7, 3, 33, False, (7,), (7,), "gelu"),
             (768, 12, 2, FIT_JOINT_S, False, (2,), (), "quick_gelu"))
    n = 0
    for d, heads, b, s, causal, ms, fms, act in cases:
        attn, mlp = block_params(d, device, seed=d + s)
        x = torch.randn(b, s, d, generator=g_in).to(device, torch.bfloat16)
        hd = d // heads
        for m in ms:
            j = m - 1
            lo, hi = head_group(heads, m, j)
            cols = head_columns(d, m, j, heads).to(device)
            ga = (attn[0], attn[1], attn[2][:, cols], attn[3][cols], attn[4][lo * hd:hi * hd])
            route = fb.slot_route(fb.group_plan(d, hd, hi - lo).da, d)
            fb.reset_launches()
            got = fb.attention_block_heads(x, *ga, heads=hi - lo, causal=causal)
            check(fb.SLOT_ROUTES[f"attention_{route}"] == 1,
                  f"phase 22 routes: attention D={d} g={hi - lo} counted {fb.SLOT_ROUTES}")
            same = torch.equal(got, fb._heads_cuda(x, *ga, hi - lo, causal, strip=False))
            check(same, f"phase 22 routes: attention_block_heads D={d} S={s} g={hi - lo}: the "
                        f"{route} partial differs from the GEMM route's")
            n += 1
        f = 4 * d
        for m in fms:
            hid = slice((m - 1) * f // m, f)
            gm = (mlp[0], mlp[1], mlp[2][:, hid], mlp[3][hid], mlp[4][hid])
            route = fb.slot_route(fb.mlp_plan(d, f // m).fp, d)
            fb.reset_launches()
            got = fb.mlp_block_cols(x, *gm, act_kind=act)
            check(fb.SLOT_ROUTES[f"mlp_{route}"] == 1,
                  f"phase 22 routes: mlp D={d} Fj={f // m} counted {fb.SLOT_ROUTES}")
            same = torch.equal(got, fb._mlp_cols_cuda(x, *gm, act, strip=False))
            check(same, f"phase 22 routes: mlp_block_cols D={d} Fj={f // m} {act}: the {route} "
                        f"partial differs from the GEMM route's")
            n += 1
        del x
    torch.cuda.synchronize()
    print(f"phase 22 routes: {n} slot partials on their routes bit-identical to "
          f"the GEMM route's (D = 768, 512 causal, 200, 203, S = {FIT_JOINT_S})")
    tp_rows_route_check(fb, fbq, device)


# the int8 row-parallel product's checks on both routes: (D, heads, m, B, S)
# of the splits the towers make (ViT-B/16 at m = 2 and 8, the text tower,
# head dim 80 and D = 200 on padded plans, D = 203 with no whole 16-byte
# int32 rows) and 256 slots of 3 head dims each (D = 768)
TP_ROWS_ROUTE_CASES = ((768, 12, 2, 2, 197), (768, 12, 8, 2, 197), (512, 8, 2, 3, 77),
                       (512, 8, 8, 3, 77), (1280, 16, 8, 2, 65), (200, 2, 4, 3, 77),
                       (203, 7, 7, 3, 33), (768, 256, 256, 1, 50))


def tp_rows_route_check(fb, fbq, device):
    """``rows_q_partial`` on its route (``fused_block_q.rows_route``) against
    the quantize pass + GEMM route (the parent design's launches) and the
    twin (on the CPU), bit for bit, at the splits of TP_ROWS_ROUTE_CASES: each head
    group's attention rows (bf16, in ``group_plan``'s padded layout) and each
    hidden-column slot's f32 hidden (``mlp_plan``'s), at the m slots' amaxes;
    each call counted on its route."""
    import torch
    from debias_vision_lang_torch.parallel.tensor import head_group

    g_in = torch.Generator().manual_seed(27)
    n, seen = 0, {"strip": 0, "gemm": 0}
    for d, heads, m, b, s in TP_ROWS_ROUTE_CASES:
        hd, f = d // heads, 4 * d
        slots = [(fb.group_plan(d, hd, hi - lo), hi - lo) for lo, hi in
                 (head_group(heads, m, j) for j in range(m)) if hi > lo]
        for half, plans in (("attention", [p for p, _ in slots[:1] + slots[-1:]]),
                            ("mlp", [fb.mlp_plan(d, f // m)])):
            dt = torch.bfloat16 if half == "attention" else torch.float32
            for plan in plans:
                lanes = plan.head_lanes() if half == "attention" else plan.hidden_columns()
                width = plan.da if half == "attention" else plan.fp
                k = lanes.numel()
                a = (torch.randn(b, s, k, generator=g_in) * 2).to(device, dt)
                a_p = torch.zeros(b, s, width, dtype=dt, device=device)
                a_p[..., lanes.to(device)] = a
                own = fbq.row_amax(a)
                amaxes = [own] + [own * (0.5 + torch.rand(b, s, 1, generator=g_in)).to(device)
                                  for _ in range(m - 1)]
                wq = torch.randint(-127, 128, (k, d), generator=g_in, dtype=torch.int8).to(device)
                wqt = wq.t().contiguous()
                route = fbq.rows_route(width, d)
                fbq.reset_launches()
                got = fbq.rows_q_partial(a_p, amaxes, wq, w_qt=wqt, plan=plan)
                check(fbq.ROWS_ROUTES[route] == 1 and sum(fbq.ROWS_ROUTES.values()) == 1,
                      f"phase 22 rows routes: {half} D={d} K={width} counted {fbq.ROWS_ROUTES}")
                other = fbq._rows_q_partial_cuda(a_p, amaxes, wqt, plan, strip=False)
                # the twin on the CPU: cuBLAS's int8 GEMM takes no N off a multiple of 8
                acc, aq, sc = fbq.rows_q_partial_plain(a.cpu(), [t.cpu() for t in amaxes],
                                                       wq.cpu())
                got_c = [t.cpu() for t in got]
                same = all(map(torch.equal, got, other)) and torch.equal(got_c[0], acc) and \
                    torch.equal(got_c[2], sc) and torch.equal(got_c[1][..., lanes], aq)
                check(same, f"phase 22 rows routes: rows_q_partial {half} D={d} m={m} K={width}: "
                            f"the {route} route, the GEMM route and the twin differ")
                seen[route] += 1
                n += 1
        del a, a_p
    torch.cuda.synchronize()
    print(f"phase 22 rows routes: {n} rows_q_partial calls ({seen['strip']} on the strip) "
          f"bit-identical to the quantize pass + GEMM route and the twin (D = 768, 512, 1280, "
          f"200, 203; m up to 256; bf16 attention rows, f32 hidden)")


def nan_rows_check(fbq, device):
    """A whole row of x NaN through K3 and K4 (and the int8 MLP slots,
    rows_q_partial, tp_reduce_q, KB (a) 1's core): JAX's _quant_rows gives
    such a row a NaN amax, a NaN scale, codes 0 and a NaN output row; every
    other row must stay bit-equal to the run without the NaN."""
    import torch
    from debias_vision_lang_torch.ops import fused_block as fb

    d, heads, b, s = 768, 12, 4, 197
    (qa, qakw), (qm, qmkw) = q_block_params(d, device, seed=26)
    x = torch.randn(b, s, d, generator=torch.Generator().manual_seed(26)).to(device,
                                                                             torch.bfloat16)
    xn = x.clone()
    xn[1, 5] = float("nan")
    outs = {}
    for tag, xi in (("clean", x), ("nan", xn)):
        k3, k4 = {}, {}
        y3 = fbq.attention_block_q(xi, *qa, heads=heads, **qakw, scratch=k3)
        y4 = fbq.mlp_block_q(xi, *qm, **qmkw, scratch=k4)
        outs[tag] = (y3, y4, k3, k4)
    (c3, c4, _, _), (y3, y4, k3, k4) = outs["clean"], outs["nan"]
    ok = torch.ones(b, s, dtype=torch.bool, device=device)
    ok[1, 5] = False
    k4_ok = bool(torch.isnan(y4[1, 5]).all() and not k4["xq"][1, 5].any()
                 and torch.isnan(k4["xs"][1, 5]).all() and not k4["hq"][1, 5].any()
                 and torch.isnan(k4["hs"][1, 5]).all() and torch.equal(y4[ok], c4[ok]))
    k3_ok = bool(torch.isnan(y3[1]).all() and not k3["xq"][1, 5].any()
                 and torch.isnan(k3["xs"][1, 5]).all()
                 and torch.equal(y3[[0, 2, 3]], c3[[0, 2, 3]]))
    # the MLP split over 8 slots: the NaN row's amax in every slot, codes 0
    hid = [slice(j * 4 * d // 8, (j + 1) * 4 * d // 8) for j in range(8)]
    hs = [fbq.mlp_block_q_cols(xn, qm[0], qm[1], qm[2][:, h], qm[3][:, h], qm[4][h],
                               w1_qt=qm[2][:, h].t().contiguous()) for h in hid]
    amaxes = [a for _, a in hs]
    parts, slot_ok = [], all(bool(torch.isnan(a[1, 5]).all()) for a in amaxes)
    for (h, _), hj in zip(hs, hid):
        acc, aq, sc = fbq.rows_q_partial(h, amaxes, qm[5][hj], w_qt=qm[5][hj].t().contiguous(),
                                         plan=fb.mlp_plan(d, 4 * d // 8))
        slot_ok = slot_ok and not aq[1, 5].any() and bool(torch.isnan(sc[1, 5]).all())
        parts.append(acc)
    red = fbq.tp_reduce_q(parts, sc, qm[6], qm[7], xn, bias_first=True)
    slot_ok = slot_ok and torch.equal(red.isnan(), y4.isnan()) and torch.equal(red[ok], y4[ok])
    # KB (a) 1's core: the NaN qkv row reaches every v column of its image
    qq = torch.randn(2, s, 3 * d, generator=torch.Generator().manual_seed(27)).to(device)
    qq_clean = fbq.attention_qq_core(qq, heads)
    qq[1, 7] = float("nan")
    qq_nan = fbq.attention_qq_core(qq, heads)
    qq_ok = bool(torch.isnan(qq_nan[1]).all() and torch.equal(qq_nan[0], qq_clean[0]))
    print(f"phase 22 NaN row (x[1, 5] all NaN, B={b} S={s} D={d}): K4 row NaN, codes 0, scales "
          f"NaN, the rest bit-equal: {k4_ok}; K3 image 1 NaN, its x codes 0, the rest "
          f"bit-equal: {k3_ok}; 8 int8 MLP slots + rows_q_partial + tp_reduce_q: NaN amaxes, "
          f"codes 0, K4's rows: {slot_ok}; KB (a) 1's core: the image NaN, the other "
          f"bit-equal: {qq_ok}")
    check(k4_ok and k3_ok and slot_ok and qq_ok, "phase 22: a NaN row is not JAX's")


def rows_routes_of(fb, fbq, d, heads, f, m, times):
    """``fbq.ROWS_ROUTES`` after ``times`` runs of an int8 block split over m
    slots: each slot holding a head quantizes its g hdp attention columns,
    each its Fp hidden columns (``fbq.rows_route`` of the plans' widths)."""
    from debias_vision_lang_torch.parallel.tensor import head_group

    want = dict.fromkeys(fbq.ROWS_ROUTES, 0)
    for j in range(m):
        lo, hi = head_group(heads, m, j)
        if hi > lo:
            want[fbq.rows_route(fb.group_plan(d, d // heads, hi - lo).da, d)] += times
    want[fbq.rows_route(fb.mlp_plan(d, f // m).fp, d)] += m * times
    return want


def slot_routes_of(fb, d, heads, f, m, times):
    """``fb.SLOT_ROUTES`` after ``times`` runs of a block split over m slots
    (only the slots that hold a head run the attention entry)."""
    from debias_vision_lang_torch.parallel.tensor import head_group

    want = dict.fromkeys(fb.SLOT_ROUTES, 0)
    for j in range(m):
        lo, hi = head_group(heads, m, j)
        if hi > lo:
            want[f"attention_{fb.slot_route(fb.group_plan(d, d // heads, hi - lo).da, d)}"] += times
    route = fb.slot_route(fb.mlp_plan(d, f // m).fp, d)
    want[f"mlp_{route}"] += m * times
    return want


def tp_blocks_check(fb, fbq, label, d, heads, f, act, layers, shape, b, s, device, card):
    """A tower of random blocks under a virtual mesh of the card through the
    split kernels (TP_WIDE): bf16 each block within 1 bf16 ulp of K1 + K2 on
    the same input, int8 bit-equal to K3 + K4, one head entry launch per
    slot that holds a head and layer, one column entry per slot and layer,
    the reduces.  Returns {kernel: launches}."""
    import torch
    from debias_vision_lang_torch.models.layers import ResidualBlock
    from debias_vision_lang_torch.ops.quant import quantize_resblocks
    from debias_vision_lang_torch.parallel import mesh as pmesh
    from debias_vision_lang_torch.parallel import tensor as tpar

    blocks = torch.nn.ModuleList()
    for i in range(layers):
        attn, mlp, _, _ = shape_params(d, f, device, seed=2200 + 17 * i + d)
        blk = ResidualBlock(d)  # F = 4 D
        sd = dict(zip(("ln_1.scale", "ln_1.bias", "attn.wqkv", "attn.bqkv", "attn.wo", "attn.bo"),
                      attn))
        sd.update(zip(("ln_2.scale", "ln_2.bias", "mlp.w1", "mlp.b1", "mlp.w2", "mlp.b2"), mlp))
        blk.load_state_dict(sd)
        blocks.append(blk.to(device))
    mesh = pmesh.create_mesh(shape, devices=[device] * (shape[0] * shape[1]))
    m = shape[1]
    busy = sum(1 for j in range(m) if tpar.head_group(heads, m, j)[1]
               > tpar.head_group(heads, m, j)[0])
    tp = tpar.TensorParallelBlocks(blocks, mesh, heads)
    qb = quantize_resblocks(blocks)
    tq = tpar.TensorParallelQBlocks(qb, mesh, heads)
    x = torch.randn(b, s, d, generator=torch.Generator().manual_seed(d)).to(device,
                                                                            torch.bfloat16)
    worst = 0.0
    with torch.no_grad():
        y = x
        for i, blk in enumerate(blocks):
            got = tp.block(i, y, route="fused", act_kind=act)
            want = fb.fused_resblock(blk, y, heads, act_kind=act)
            err = (got.float() - want.float()).abs().max().item()
            tol = ulp_bf16(want.float().abs().max().item())
            worst = max(worst, err / tol)
            check(err <= tol, f"phase 22 {label} {shape} bf16 block {i}: {err} > 1 ulp {tol}")
            y = want
        reset_all(fb, fbq)
        tp.run(x, route="fused", act_kind=act)
        torch.cuda.synchronize()
        counts = dict(fb.TP_LAUNCHES)
        want = {"attention_block_heads": layers * busy, "mlp_block_cols": layers * m,
                "tp_reduce": layers * 2}
        check({k: counts[k] for k in want} == want and sum(fb.LAUNCHES.values()) == 0,
              f"phase 22 {label} {shape} bf16 launches {counts}; expected {want}")
        reset_all(fb, fbq)
        got8 = tq.run(x, route="fused", act_kind=act)
        torch.cuda.synchronize()
        qcounts, k34 = dict(fbq.TP_LAUNCHES), dict(fbq.LAUNCHES)
        want8 = fbq.fused_transformer_q(qb, x, heads, act_kind=act)
        qwant = {"attention_block_q_heads": layers * busy, "mlp_block_q_cols": layers * m,
                 "rows_q_partial": layers * (busy + m),
                 "tp_reduce_q": layers * 2}
        check({k: qcounts[k] for k in qwant} == qwant and sum(k34.values()) == 0,
              f"phase 22 {label} {shape} int8 launches {qcounts}, K3 / K4 {nonzero(k34)}; "
              f"expected {qwant} and none")
    same = torch.equal(got8, want8)
    print(f"phase 22 {label} D={d} heads={heads} (hd {d // heads}) F={f} {layers} layers B={b} "
          f"S={s} under {shape}: slot heads {[tpar.head_group(heads, m, j) for j in range(m)]} "
          f"({m - busy} without a head); bf16 every block within 1 ulp of K1 + K2 (worst "
          f"{worst:.3f} ulp), launches {nonzero(counts)}; int8 "
          f"{'bit-equal to' if same else 'differs from'} K3 + K4, launches {nonzero(qcounts)}")
    check(same, f"phase 22 {label} {shape}: the int8 tower is not K3 + K4's")
    del blocks, tp, tq, qb, x
    torch.cuda.empty_cache()
    return {**counts, **qcounts}


def vit_prologue(v, p8):
    """The bf16 image tower's input from uint8 staging: the folded stem,
    the class token, positions and ln_pre (``clip._vit_trunk``'s)."""
    import torch
    from debias_vision_lang_torch.models.clip import fold_preprocess_into_patch
    from debias_vision_lang_torch.models.layers import layer_norm

    cfg = v.cfg
    w_f, b_f = fold_preprocess_into_patch(v.conv1.kernel, cfg.image_mean, cfg.image_std,
                                          v.conv1.bias)
    x = (torch.matmul(p8.to(torch.bfloat16).float(), w_f.to(torch.bfloat16).float())
         .to(torch.bfloat16) + b_f.to(torch.bfloat16))
    cls = v.class_embedding.to(torch.bfloat16).expand(x.shape[0], 1, cfg.width)
    return layer_norm(v.ln_pre, torch.cat([cls, x], dim=1)
                      + v.positional_embedding.to(torch.bfloat16))


def vit_head(v, y):
    from debias_vision_lang_torch.models.layers import layer_norm

    return (layer_norm(v.ln_post, y[:, 0, :]) @ v.proj.to(y.dtype)).float()


def twin_image_tower(model, fb, p8):
    """The bf16 image tower with every block on the twins (K1 + K2's plain
    versions): its rows [B, embed] as f32."""
    from debias_vision_lang_torch.ops.fused_block import _block_args

    v = model.clip.visual
    y = vit_prologue(v, p8)
    for blk in v.resblocks:
        a, mlp = _block_args(blk)
        y = fb.resblock_plain(y, a + mlp, v.cfg.heads)
    return vit_head(v, y)


def twin_text_tower(model, fb, tokens):
    """``DebiasCLIP.encode_text`` at bf16 with every block on the twins: its
    rows [B, embed] as f32."""
    import torch
    from debias_vision_lang_torch.models import clip as clip_model
    from debias_vision_lang_torch.models.debias import debias_eot_index, inject_prompts
    from debias_vision_lang_torch.models.layers import layer_norm
    from debias_vision_lang_torch.ops.fused_block import _block_args

    t = model.clip.text
    raw = clip_model.add_positional(t, clip_model.embed_tokens(t, tokens, torch.bfloat16))
    y = inject_prompts(raw, model.debias_tokens, tokens, model.debias_cfg.debias_pos)
    for blk in t.resblocks:
        a, mlp = _block_args(blk)
        y = fb.resblock_plain(y, a + mlp, t.cfg.heads, causal=True)
    y = layer_norm(t.ln_final, y)
    idx = debias_eot_index(tokens, model.debias_tokens.shape[0], y.shape[1])
    return clip_model.pool_and_project(t, y, idx).float()


def kb_tower(model, fb, p8, card):
    """KB (a) 6 on a path: the phase-4 image tower's 12 attention halves
    through attention_block_hgrid (each block's weights pre-scaled as KB's
    main() builds them), the MLPs through K2, against the K1 tower; and 12
    hgrid attention blocks timed beside 12 K1 ones (KB's own timing).
    Returns the hgrid launches of the tower."""
    import torch
    from debias_vision_lang_torch.ops.fused_block import _block_args

    v = model.clip.visual
    cfg = v.cfg
    with torch.no_grad():
        x0 = vit_prologue(v, p8)
        ops = [(hgrid_operands(_block_args(blk)[0], cfg.heads), _block_args(blk)[1])
               for blk in v.resblocks]
        fb.reset_launches()
        y = x0
        for kb, mlp in ops:
            y = fb.mlp_block(fb.attention_block_hgrid(y, *kb, heads=cfg.heads), *mlp)
        torch.cuda.synchronize()
        launches = dict(fb.TP_LAUNCHES)
        ref = x0
        for blk in v.resblocks:
            ref = fb.fused_resblock(blk, ref, cfg.heads)
        cos = torch.nn.functional.cosine_similarity(vit_head(v, y), vit_head(v, ref), dim=-1)
        print(f"phase 22 KB (a) 6 tower: the phase-4 image tower's 12 attention halves "
              f"through attention_block_hgrid ({launches['attention_block_hgrid']} launches), "
              f"image rows vs the K1 tower: cosine min {cos.min().item():.7f} (bar {COS_MIN})")
        check(launches["attention_block_hgrid"] == LAYERS and cos.min().item() >= COS_MIN,
              "phase 22: the KB (a) 6 tower drifts from K1's")
        t_kb = cuda_ms(lambda: [fb.attention_block_hgrid(x0, *kb, heads=cfg.heads)
                                for kb, _ in ops], iters=3)
        t_k1 = cuda_ms(lambda: [fb.attention_block(x0, *_block_args(blk)[0], heads=cfg.heads)
                                for blk in v.resblocks], iters=3)
        print(f"phase 22 12 attention blocks at B={BATCH}: KB (a) 6 {t_kb:.3f} ms, K1 "
              f"{t_k1:.3f} ms ({card})")
    return launches["attention_block_hgrid"]


def dryrun_step(model, device, seed=0, b=TP_DRY_B):
    """__graft_entry__.dryrun_multichip's step on the port at ViT-B/16's
    width: frozen image embeddings, one Adam step of the adversary on the
    prompts' scores, then the prompt loss (contrastive - adversarial) and
    its token gradient.  Returns (adversary loss, loss, token gradient)."""
    import torch
    from debias_vision_lang_torch.core.config import TrainConfig
    from debias_vision_lang_torch.models.adversary import Adversary
    from debias_vision_lang_torch.text import ByteTokenizer
    from debias_vision_lang_torch.train.adversarial import (clip_contrastive_loss,
                                                            sigmoid_bce, similarity_scores)

    tcfg = TrainConfig()
    g = torch.Generator().manual_seed(seed)
    imgs = torch.randn(b, 224, 224, 3, generator=g).to(device)
    cap_imgs = torch.randn(b, 224, 224, 3, generator=g).to(device)
    labels = (torch.arange(b) % 2).float().to(device)
    tok = ByteTokenizer()
    sens = torch.as_tensor(tok(["a good person", "a bad person", "a doctor", "a criminal"]),
                           dtype=torch.long, device=device)
    caps = torch.as_tensor(tok([f"a photo of person {i}" for i in range(b)]), dtype=torch.long,
                           device=device)
    adv = Adversary.from_cfg({"ADV_N_INPUT": 4, "ADV_N_OUTPUT": 1, "ADV_HIDDEN_SIZE": 8,
                              "SEED": 2}).to(device)
    with torch.no_grad():
        img = model.encode_image(imgs, dtype=torch.float32).float()
        cap = model.encode_image(cap_imgs, dtype=torch.float32).float()
        sens_embs = model.encode_text(sens)
    scale = model.logit_scale.detach()
    opt = torch.optim.Adam(adv.parameters(), lr=tcfg.adversary_lr)
    adv_loss = sigmoid_bce(adv(similarity_scores(img, sens_embs, scale))[:, 0], labels)
    opt.zero_grad()
    adv_loss.backward()
    opt.step()
    a = sigmoid_bce(adv(similarity_scores(img, model.encode_text(sens), scale))[:, 0], labels)
    c = clip_contrastive_loss(cap, model.encode_text(caps), scale)
    loss = tcfg.contrastive_weight * c - tcfg.adversarial_weight * a
    (grad,) = torch.autograd.grad(loss, model.debias_tokens)
    return adv_loss.item(), loss.item(), grad


def tp_phase(model, tokenizer, prompts, card, device):
    """Phase 22: tensor parallel on the phase-4 ViT-B/16 DebiasCLIP at full
    width, on virtual (data, model) meshes of the one card (the split's
    overhead, not a speed-up): the split kernels against their twins and
    KB (a) 6 beside K1; the float32 forward under (1, 2) and (2, 2) against
    unsharded (JAX's 1e-4); bf16 and int8 towers under (1, 2), (2, 2) and
    (1, 4) against the unsharded kernels (bf16: each block within 1 ulp,
    rows cosine against the drift floor; int8: bit-equal), the split kernels counted; the
    Frozen-in-Time joint int8 tower (S = 785, the long core) under (1, 2);
    the float32 dryrun step under (2, 2).  Returns (kernels-line rows, wall)."""
    import torch
    from debias_vision_lang_torch.data.loader import HostLoader
    from debias_vision_lang_torch.ops import fused_block as fb
    from debias_vision_lang_torch.ops import fused_block_q as fbq
    from debias_vision_lang_torch.ops.quant import QuantizedCLIP
    from debias_vision_lang_torch.parallel import mesh as pmesh

    t_phase = time.perf_counter()
    walls = {}
    vis = model.clip_cfg.vision
    rows, k1_ms = tp_kernels(fb, fbq, device, card)
    walls["kernels"] = time.perf_counter() - t_phase
    t = time.perf_counter()
    tp_slot_split(fbq, device)
    tp_slot_split(fb, device, bf16=True)
    walls["slot split"] = time.perf_counter() - t
    t = time.perf_counter()
    tp_route_check(fb, fbq, device)
    nan_rows_check(fbq, device)
    walls["routes, NaN rows"] = time.perf_counter() - t
    loader = HostLoader(SyntheticFaces(BATCH, seed=22), batch_size=BATCH, num_workers=8,
                        native_n_px=vis.image_size, native_patch=vis.patch_size)
    p8 = torch.from_numpy(next(iter(loader)).images).to(device)
    tokens = torch.as_tensor(tokenizer(prompts), dtype=torch.long, device=device)

    t = time.perf_counter()
    rows["attention_block_hgrid"]["launches"] = kb_tower(model, fb, p8, card)
    walls["KB tower"] = time.perf_counter() - t

    def mesh_of(shape):
        return pmesh.create_mesh(shape, devices=[device] * (shape[0] * shape[1]))

    # float32: the plain route, against unsharded
    t = time.perf_counter()
    g = torch.Generator().manual_seed(23)
    imgs = torch.randn(TP_F32_B, 224, 224, 3, generator=g).to(device)
    with torch.no_grad():
        ref, _ = model(imgs, tokens[:32])
        for shape in ((1, 2), (2, 2)):
            placed = pmesh.shard_clip_params(model, mesh_of(shape))
            reset_all(fb, fbq)
            got, _ = placed(imgs, tokens[:32])
            err = (got - ref).abs().max().item()
            print(f"phase 22 float32 TP forward {shape}: logits of {TP_F32_B} images x 32 prompts "
                  f"max |diff| {err} vs unsharded (bar {TP_F32_ATOL}, JAX's); kernel launches "
                  f"{nonzero({**launches_of(fb, fbq), **fb.TP_LAUNCHES, **fbq.TP_LAUNCHES})}")
            check(err <= TP_F32_ATOL, f"phase 22: float32 TP logits {shape} off by {err}")
            check(sum(launches_of(fb, fbq).values()) + sum(fb.TP_LAUNCHES.values()) == 0,
                  "phase 22: the float32 plain route launched kernels")
            del placed
    walls["float32"] = time.perf_counter() - t

    # bf16 and int8 towers
    t = time.perf_counter()
    with torch.no_grad():
        ref32 = model.encode_image(p8, dtype=torch.float32).float()
        txt32 = model.encode_text(tokens).float()
        one16 = model.encode_image(p8, dtype=torch.bfloat16).float()
        txt16 = model.encode_text(tokens, dtype=torch.bfloat16).float()
        q_one = QuantizedCLIP(model, quantize_text=True)
        q_img, q_txt = q_one.encode_image(p8), q_one.encode_text(tokens)
        ms_one = {"bf16": cuda_ms(lambda: model.encode_image(p8, dtype=torch.bfloat16), 3),
                  "int8": cuda_ms(lambda: q_one.encode_image(p8), 3)}
        x_img = torch.randn(BATCH, 197, vis.width, generator=g).to(device, torch.bfloat16)
        x_txt = torch.randn(len(prompts), 77, 512, generator=g).to(device, torch.bfloat16)
        # the drift floors: each tower with every block on the twins
        floors = {"image": torch.nn.functional.cosine_similarity(
                      twin_image_tower(model, fb, p8), one16, dim=-1).min().item(),
                  "text": torch.nn.functional.cosine_similarity(
                      twin_text_tower(model, fb, tokens), txt16, dim=-1).min().item()}
        bars = {}
        for tag, floor in floors.items():
            bars[tag] = min(TP_COS_BF16, 1 - TP_DRIFT_RATIO * (1 - floor))
            print(f"phase 22 drift floor: the bf16 {tag} tower on the twins (each block within "
                  f"1 ulp of K1 + K2) vs on the kernels: rows cosine min {floor:.7f} (bar "
                  f"{TP_FLOOR_MIN}); the TP {tag} tower's bar {bars[tag]:.7f}")
            check(floor >= TP_FLOOR_MIN, f"phase 22: the bf16 {tag} twins drift from the kernels")
        for shape in TP_MESHES:
            d, m = shape
            mesh = mesh_of(shape)
            placed = pmesh.shard_clip_params(model, mesh)
            worst, flipped = 0.0, 0.0
            for tower, x_in, causal, blocks in (
                    ("image", x_img, False, model.clip.visual.resblocks),
                    ("text", x_txt, True, model.clip.text.resblocks)):
                tp_blocks = (placed.clip.visual if tower == "image" else placed.clip.text).resblocks
                heads = vis.heads if tower == "image" else model.clip_cfg.text.heads
                y = x_in
                for i, blk in enumerate(blocks):
                    got = tp_blocks.block(i, y, route="fused", causal=causal)
                    want = fb.fused_resblock(blk, y, heads, causal=causal)
                    err = (got.float() - want.float()).abs().max().item()
                    tol = ulp_bf16(want.float().abs().max().item())
                    worst = max(worst, err / tol)
                    flipped = max(flipped, got.ne(want).float().mean().item())
                    check(err <= tol, f"phase 22 {shape} {tower} block {i}: {err} > 1 ulp {tol}")
                    y = want
            print(f"phase 22 bf16 {shape}: every image and text block within 1 bf16 ulp of "
                  f"K1 + K2 on the same input (worst {worst:.3f} ulp; at most {flipped:.2e} of "
                  f"a block's outputs differ)")
            reset_all(fb, fbq)
            img = placed.encode_image(p8, dtype=torch.bfloat16).float()
            torch.cuda.synchronize()
            counts = dict(fb.TP_LAUNCHES)
            want = {"attention_block_heads": LAYERS * m * d, "mlp_block_cols": LAYERS * m * d,
                    "tp_reduce": 2 * LAYERS * d}
            check({k: counts[k] for k in want} == want and sum(fb.LAUNCHES.values()) == 0,
                  f"phase 22 bf16 {shape} image tower launches {counts}, K1-K4 "
                  f"{nonzero(fb.LAUNCHES)}; expected {want} and none")
            routes = dict(fb.SLOT_ROUTES)
            want_routes = slot_routes_of(fb, vis.width, vis.heads, 4 * vis.width, m, LAYERS * d)
            print(f"phase 22 bf16 {shape} image tower slot routes {nonzero(routes)}")
            check(routes == want_routes, f"phase 22 bf16 {shape}: slot routes {routes}, expected "
                                         f"{want_routes}")
            if shape == (1, 2):
                for k in ("attention_block_heads", "mlp_block_cols", "tp_reduce"):
                    rows[k]["launches"] = counts[k]
            if shape == (1, 8):
                for key, k in TP8:
                    if k in counts:
                        rows[key]["launches"] = counts[k]
            reset_all(fb, fbq)
            txt = placed.encode_text(tokens, dtype=torch.bfloat16).float()
            tcount = dict(fb.TP_LAUNCHES)
            check(tcount["attention_block_heads_causal"] == LAYERS * m * d
                  and sum(fb.LAUNCHES.values()) == 0, f"phase 22 bf16 text launches {tcount}")
            for tag, a, one, f32 in (("image", img, one16, ref32), ("text", txt, txt16, txt32)):
                c1 = torch.nn.functional.cosine_similarity(a, one, dim=-1).min().item()
                c32 = torch.nn.functional.cosine_similarity(a, f32, dim=-1).min().item()
                print(f"phase 22 bf16 {shape} {tag} rows: cosine min {c1:.7f} vs unsharded bf16 "
                      f"(bar {bars[tag]:.7f}), {c32:.6f} vs float32 (bar {COS_MIN})")
                check(c1 >= bars[tag] and c32 >= COS_MIN, f"phase 22 bf16 {shape} {tag} drifts")
            ms_tp = cuda_ms(lambda: placed.encode_image(p8, dtype=torch.bfloat16), 3)
            del placed
            q_tp = pmesh.shard_quantized_clip(q_one, mesh)
            reset_all(fb, fbq)
            qi = q_tp.encode_image(p8)
            torch.cuda.synchronize()
            counts = dict(fbq.TP_LAUNCHES)
            want = {"attention_block_q_heads": LAYERS * m * d, "mlp_block_q_cols": LAYERS * m * d,
                    "rows_q_partial": 2 * LAYERS * m * d, "tp_reduce_q": 2 * LAYERS * d}
            check({k: counts[k] for k in want} == want and sum(fbq.LAUNCHES.values()) == 0,
                  f"phase 22 int8 {shape} image launches {counts}; expected {want}")
            inputs, rroutes = dict(fbq.ROWS_INPUTS), dict(fbq.ROWS_ROUTES)
            want_rows = rows_routes_of(fb, fbq, vis.width, vis.heads, 4 * vis.width, m, LAYERS * d)
            print(f"phase 22 int8 {shape} image tower rows_q_partial: {nonzero(inputs)} by input "
                  f"(attention bf16, MLP f32), routes {nonzero(rroutes)}")
            half = LAYERS * m * d  # each slot's attention rows, then its hidden
            check(inputs == {"bf16": half, "f32": half} and rroutes == want_rows,
                  f"phase 22 int8 {shape}: rows_q_partial inputs {inputs}, routes {rroutes}, "
                  f"expected {want_rows}")
            if shape == (1, 2):
                for k in want:
                    rows[k]["launches"] = counts[k]
            if shape == (1, 8):
                for key, k in TP8:
                    if k in counts:
                        rows[key]["launches"] = counts[k]
            if shape in ((1, 2), (1, 8)):  # the row-parallel product by half
                for key, dt in TP_ROWS_INPUT.items():
                    if ("m=8" in key) == (shape == (1, 8)):
                        rows[key]["launches"] = inputs[dt]
            reset_all(fb, fbq)
            qt = q_tp.encode_text(tokens)
            tcount = dict(fbq.TP_LAUNCHES)
            check(tcount["attention_block_q_heads_causal"] == LAYERS * m * d
                  and sum(fbq.LAUNCHES.values()) == 0, f"phase 22 int8 text launches {tcount}")
            for tag, a, one in (("image", qi, q_img), ("text", qt, q_txt)):
                same = torch.equal(a, one)
                if not same:
                    cos = torch.nn.functional.cosine_similarity(a.float(), one.float(), dim=-1)
                    diff = (a.float() - one.float()).abs()
                    print(f"phase 22 int8 {shape} {tag}: NOT bit-equal: {int(diff.ne(0).any(-1).sum())} "
                          f"rows differ, max |diff| {diff.max().item()}, cosine min "
                          f"{cos.min().item():.7f} (held to {TP_COS})")
                    check(cos.min().item() >= TP_COS, f"phase 22 int8 {shape} {tag} drifts")
                else:
                    print(f"phase 22 int8 {shape} {tag} rows: bit-equal to the unsharded int8 "
                          f"tower")
            ms_q = cuda_ms(lambda: q_tp.encode_image(p8), 3)
            print(f"phase 22 overhead {shape}: image tower B={BATCH} bf16 {ms_tp:.3f} ms "
                  f"(unsharded {ms_one['bf16']:.3f}), int8 {ms_q:.3f} ms (unsharded "
                  f"{ms_one['int8']:.3f}) ({card})")
            del q_tp
            torch.cuda.empty_cache()
    walls["towers"] = time.perf_counter() - t

    # the Frozen-in-Time joint int8 tower: S = 785 on the long core
    t = time.perf_counter()
    from debias_vision_lang_torch.models.loader import model_loader

    fit, _, _, _ = model_loader(FIT_ARCH, pretrained=False, seed=0, device=device)
    fit.attention = "joint"
    fit.eval()
    with torch.no_grad():
        qf = QuantizedCLIP(fit)
        videos = torch.randn(TP_FIT_B, FIT_FRAMES, 224, 224, 3, generator=g).to(device)
        one = qf.encode_image(videos)
        qf_tp = pmesh.shard_quantized_clip(qf, mesh_of((1, 2)))
        reset_all(fb, fbq)
        got = qf_tp.encode_image(videos)
        torch.cuda.synchronize()
        routes, counts = dict(fbq.CORE_ROUTES), dict(fbq.TP_LAUNCHES)
    same = torch.equal(got, one)
    print(f"phase 22 FiT joint int8 tower B={TP_FIT_B} (S = {FIT_JOINT_S}) under (1, 2): "
          f"{'bit-equal to' if same else 'differs from'} the unsharded int8 tower; core routes "
          f"{routes}, launches {nonzero(counts)}")
    check(routes == {"short": 0, "long": 2 * LAYERS}, f"phase 22 FiT: core routes {routes}")
    if not same:
        cos = torch.nn.functional.cosine_similarity(got.float(), one.float(), dim=-1).min().item()
        check(cos >= TP_COS, f"phase 22 FiT joint int8 TP drifts: cosine {cos}")
    del fit, qf, qf_tp, videos
    torch.cuda.empty_cache()
    walls["FiT"] = time.perf_counter() - t

    # towers of random blocks off the registry splits
    t = time.perf_counter()
    for label, d, heads, f, act, layers, shape, b, s in TP_WIDE:
        tp_blocks_check(fb, fbq, label, d, heads, f, act, layers, shape, b, s, device, card)
    walls["off-registry towers"] = time.perf_counter() - t

    # the dryrun step: float32 adversary + prompt step, CLIP placed under (2, 2)
    t = time.perf_counter()
    base = copy.deepcopy(model)
    for p in base.clip.parameters():
        p.requires_grad_(False)
    placed = pmesh.shard_clip_params(base, mesh_of((2, 2)))
    a1, l1, g1 = dryrun_step(base, device)
    a2, l2, g2 = dryrun_step(placed, device)
    gerr = (g2 - g1).abs().max().item()
    gmag = g1.abs().max().item()
    # float32's own noise on this gradient: the same unsharded step on the
    # CPU (another order of every float32 sum)
    t_cpu = time.perf_counter()
    _, _, g_cpu = dryrun_step(copy.deepcopy(base).cpu(), torch.device("cpu"))
    floor = (g_cpu.to(device) - g1).abs().max().item()
    t_cpu = time.perf_counter() - t_cpu
    print(f"phase 22 dryrun step (2, 2) float32: token gradient max |diff| {gerr} of max "
          f"{gmag} ({gerr / gmag:.3e} of it; bar {TP_GRAD_TOL} of it); the unsharded step on "
          f"the CPU differs from the card's by {floor} ({floor / gmag:.3e}; {t_cpu:.1f} s of "
          f"CPU); losses adversary {a1} vs {a2}, prompt {l1} vs {l2} (bar {TP_LOSS_TOL})")
    check(gmag > 0 and gerr <= TP_GRAD_TOL * gmag, "phase 22: the dryrun gradient drifts")
    check(abs(a1 - a2) <= TP_LOSS_TOL and abs(l1 - l2) <= TP_LOSS_TOL,
          "phase 22: the dryrun losses drift")
    del base, placed
    torch.cuda.empty_cache()
    walls["dryrun"] = time.perf_counter() - t
    for name, r in rows.items():
        check(r["launches"], f"phase 22: {name} has no launch count")
    wall = time.perf_counter() - t_phase
    print(f"phase 22 walls: " + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
          + f"; total {wall:.2f} s ({card})")
    return ([rows[k] for k in TP_REPLACES] + [rows["rows_q_partial mlp"]]
            + [rows[key] for key, _ in TP8], wall)


# ---------------------------------------------------------------------------
# phase 23: the int8 kernel experiments of benchmarks/ (KB (a) 1-4)
# ---------------------------------------------------------------------------

KB_S, KB_D, KB_H, KB_F = 197, 768, 12, 3072  # ViT-B/16, the scripts' model
KB_CHECK_B = 8  # the kernels against their twins; timed at BATCH
KB_REPLACES = {
    "attention_block_qq": "benchmarks/attn_int8_cores.py:57",
    "attention_qq_core": "benchmarks/attn_int8_cores.py:57",
    "mlp_block_q_bf16h": "benchmarks/q_mlp_bf16h.py:101",
    "mlp_block_q_var": "benchmarks/q_kernel_variants.py:117",
    "mlp_block_q_var_bf16_gelu": "benchmarks/q_kernel_variants.py:117",
    "attention_block_q_var": "benchmarks/q_kernel_variants.py:221",
}
# the tower halves of the KB scripts' scans: (entry point name, attention
# half?, keyword arguments); k3 / k4 are the baselines
KB_KINDS = {"k3": ("attention_block_q", True, {}), "qq": ("attention_block_qq", True, {}),
            "attn_var": ("attention_block_q_var", True, {}),
            "k4": ("mlp_block_q", False, {}), "bf16h": ("mlp_block_q_bf16h", False, {}),
            "mlp_var": ("mlp_block_q_var", False, {}),
            "mlp_var_bf16_gelu": ("mlp_block_q_var", False, {"bf16_gelu": True})}


def kb_int8_tower(fbq, blocks, kind, heads=KB_H, kinds=None):
    """One int8 block kind (of ``kinds``, KB_KINDS by default) over every
    quantized resblock (``ops/quant.QuantBlock``), as the KB scripts' scans
    chain them: the attention halves alone or the MLP halves alone.
    Returns x -> the tower's output."""
    name, attention, kw = (kinds or KB_KINDS)[kind]
    fn = getattr(fbq, name)

    def run(x):
        for blk in blocks:
            if attention:
                x = fn(x, blk.ln_1.scale, blk.ln_1.bias, blk.wqkv.q, blk.wqkv.scale, blk.bqkv,
                       blk.wo.q, blk.wo.scale, blk.bo, heads=heads, wqkv_qt=blk.wqkv.qt,
                       wo_qt=blk.wo.qt, **kw)
            else:
                x = fn(x, blk.ln_2.scale, blk.ln_2.bias, blk.w1.q, blk.w1.scale, blk.b1, blk.w2.q,
                       blk.w2.scale, blk.b2, w1_qt=blk.w1.qt, w2_qt=blk.w2.qt, **kw)
        return x
    return run


def kb_inputs(b, n=2, seed=23):
    """The KB scripts' inputs: ``rng.normal(size=(B, S, D)) * 0.5`` in bf16,
    ``n`` buffers, on the card."""
    import torch

    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.normal(size=(b, KB_S, KB_D)) * 0.5).astype(np.float32))
            .to("cuda", torch.bfloat16) for _ in range(n)]


def qq_work(b, s, d, h):
    """KB (a) 1's block: K3's products and the core's Q K^T and P V, all
    int8; x and out bf16, the weights, scales and biases read once."""
    ops, nbytes = attention_block_work(b, s, d, weights="int8")
    return {"int8": ops["int8"] + 4 * b * s * s * d}, nbytes


def qq_core_work(b, s, d, h):
    """The int8 core alone: Q K^T and P V int8 over the true head dim, the
    f32 qkv read and the bf16 attention rows written once."""
    return {"int8": 4 * b * s * s * d}, b * s * 3 * d * 4 + b * s * d * 2


def qq_core_check(fbq, qkv, heads):
    """The int8 core on the kernel's own f32 qkv against its twin: its p
    codes are quant_rows of its own p, its output is the twin's P V on
    those codes bit for bit, and the output within 1 bf16 ulp of the twin's
    largest magnitude; differences past it counted, each a flipped p code
    (v codes are checked equal).  Returns the largest output difference."""
    import torch

    sk, sr = {}, {}
    got = fbq.attention_qq_core(qkv, heads, scratch=sk)
    ref = fbq.attention_qq_core_plain(qkv, heads, torch.bfloat16, scratch=sr)
    b, s, d3 = qkv.shape
    d = d3 // 3
    hd = d // heads
    check(torch.equal(fbq.quant_rows(sk["p"])[0], sk["pq"])
          and torch.equal(fbq.quant_rows(sk["p"])[1], sk["psc"]),
          "attention_qq_core: its p codes are not the quantization of its own p")
    vq, vsc = fbq.quant_rows(qkv[..., 2 * d:].reshape(b, s, heads, hd).permute(0, 2, 3, 1))
    own = (sk["pq"].double() @ vq.transpose(-1, -2).double()).float() * sk["psc"] \
        * vsc.transpose(-1, -2)
    own = own.to(torch.bfloat16).permute(0, 2, 1, 3).reshape(b, s, d)
    check(torch.equal(got, own), "attention_qq_core: the output is not P V on its own codes")
    p_err = (sk["p"] - sr["p"]).abs().max().item()
    flips = (sk["pq"] != sr["pq"])
    err = (got.float() - ref.float()).abs()
    tol = ulp_bf16(ref.float().abs().max().item())
    past = err > tol
    # each output element past 1 ulp sits on a (image, query row, head) whose p row
    # holds a flipped code
    rows_flipped = flips.any(-1).permute(0, 2, 1)  # [B, S, H]
    past_rows = past.reshape(b, s, heads, hd).any(-1)
    unexplained = (past_rows & ~rows_flipped).sum().item()
    print(f"kernel attention_qq_core B={b} S={s} hd={hd} ({fbq.qq_route(s, hd)} route) on the "
          f"kernel's own f32 qkv: max_abs_err "
          f"{err.max().item()} (tolerance {tol} = 1 bf16 ulp of max |twin|); p codes = "
          f"quant_rows of its own p, output = P V on its own codes (bit-equal); p vs the "
          f"twin's max |diff| {p_err}; {int(flips.sum())} of {flips.numel()} p codes differ "
          f"from the twin's (max |diff| {(sk['pq'].int() - sr['pq'].int()).abs().max().item()}); "
          f"{int(past.sum())} outputs past 1 ulp, {unexplained} of their rows without a "
          f"flipped p code")
    check(p_err <= 1e-6, f"attention_qq_core: p off the twin's by {p_err}")
    check(unexplained == 0, "attention_qq_core: an output past 1 ulp without a flipped p code")
    return err.max().item()


def kb_compare(fbq, name, kern, plain, x, block, kw, quant, attention, code_bars=True,
               own_step=None):
    """A KB block kernel against its twin at the timed shape: every int8 code
    the twin's quantizer of the kernel's own rows (its x and hidden codes
    within phase 6's bars of the twin's; the qq block's attention codes,
    which the core's flipped p codes move, printed), the output within 1
    bf16 ulp of the twin's last step on the kernel's own codes (the out- or
    down-projection), and within 1 ulp of the twin's own output unless some
    code differs from the twin's (then the difference is printed).  Returns
    the largest output difference from the twin."""
    import torch

    args, qkw = block
    sk, sr = {}, {}
    got = kern(x, *args, **kw, **qkw, scratch=sk)
    ref = plain(x, *args, **kw, scratch=sr)
    sk = k4_ln_rows(fbq, sk, x, block, kw)
    codes_of = (("xq", "xn", "xs"), ("aq", "attn", "as") if attention else ("hq", "h", "hs"))
    n_diff = 0
    for codes, rows, scales in codes_of:
        q, sc = quant(sk[rows])
        check(torch.equal(q, sk[codes]) and torch.equal(sc, sk[scales]),
              f"{name}: its {codes} codes are not the quantization of its own {rows} rows")
        diff = (sk[codes].int() - sr[codes].int()).abs()
        n_diff += int(diff.ne(0).sum())
        share = diff.ne(0).float().mean().item()
        print(f"  {name} {codes}: {share:.3e} differ from the twin's, max |diff| "
              f"{diff.max().item()}")
        if code_bars or codes == "xq":
            check(diff.max().item() <= CODE_DIFF_MAX[codes] and share <= CODE_SHARE_MAX,
                  f"{name}: {codes} codes drift from the twin's")
    c, s_ = codes_of[1][0], codes_of[1][2]
    if own_step is not None:  # the last step's f32 result from the kernel's own rows
        own = own_step(sk)
    elif attention:
        own = (x.float() + (fbq.dot_q(sk[c], sk[s_], args[5], args[6]) + args[7].float()))
    else:
        own = (x.float() + args[7].float()) + fbq.dot_q(sk[c], sk[s_], args[5], args[6])
    own = own.to(x.dtype)
    own_err = (got.float() - own.float()).abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    tol = ulp_bf16(ref.float().abs().max().item())
    print(f"kernel {name}: max_abs_err {err} (1 bf16 ulp of max |twin| {tol}); vs the twin's "
          f"last step on its own codes {own_err}; {n_diff} codes off the twin's")
    check(math.isfinite(err) and own_err <= ulp_bf16(own.float().abs().max().item()),
          f"{name}: the output is off the twin's last step on its own codes")
    check(err <= tol or n_diff > 0, f"{name}: past 1 ulp of its twin with the twin's codes")
    return err


def kb_checks(fbq, device, card):
    """Each KB entry against its twin at B=8 (x and x/16) on the phase-6
    block's weights, then timed at B=256 beside K3 / K4.  Returns the
    kernels-line rows (launches set by the caller)."""
    import torch

    d, heads, s, b = KB_D, KB_H, KB_S, KB_CHECK_B
    (qa, qakw), (qm, qmkw) = q_block_params(d, device, seed=7)
    g = torch.Generator().manual_seed(23)
    for scale in (1.0, 1 / 16):
        x = (torch.randn(b, s, d, generator=g) * scale).to(device, torch.bfloat16)
        tag = f"B={b} S={s} D={d} x~N(0,{scale}^2)"
        # qq: the block (output, x and attention codes), then its core on its own qkv
        sk, sr = {}, {}
        got = fbq.attention_block_qq(x, *qa, heads=heads, **qakw, scratch=sk)
        ref = fbq.attention_block_qq_plain(x, *qa, heads=heads, scratch=sr)
        err = (got.float() - ref.float()).abs().max().item()
        tol = ulp_bf16(ref.float().abs().max().item())
        for codes, rows, scales in (("xq", "xn", "xs"), ("aq", "attn", "as")):
            q, sc = fbq.quant_rows(sk[rows])
            check(torch.equal(q, sk[codes]) and torch.equal(sc, sk[scales]),
                  f"attention_block_qq: its {codes} codes are not the quantization of its "
                  f"own {rows} rows")
        xdiff = (sk["xq"].int() - sr["xq"].int()).abs()
        adiff = (sk["aq"].int() - sr["aq"].int()).abs()
        print(f"kernel attention_block_qq {tag}: max_abs_err {err} (tolerance {tol} = 1 bf16 "
              f"ulp of max |twin|); xq, aq codes the quantization of its own rows; xq "
              f"{xdiff.ne(0).float().mean().item():.3e} differ from the twin's (max "
              f"{xdiff.max().item()}, bar {CODE_DIFF_MAX['xq']}); aq "
              f"{adiff.ne(0).float().mean().item():.3e} (max {adiff.max().item()}; the core's "
              f"flipped p codes move attention rows)")
        check(math.isfinite(err) and err <= tol, "attention_block_qq: kernel disagrees with its twin")
        check(xdiff.max().item() <= CODE_DIFF_MAX["xq"]
              and xdiff.ne(0).float().mean().item() <= CODE_SHARE_MAX,
              "attention_block_qq: x codes drift from the twin's")
        qq_core_check(fbq, sk["qkv"], heads)
        compare_q(fbq, f"attention_block_q_var {tag}", fbq.attention_block_q_var,
                  fbq.attention_block_q_var_plain, x, (qa, qakw), {"heads": heads},
                  quant=fbq.quant_rows_recip)
        compare_q(fbq, f"mlp_block_q_bf16h {tag}", fbq.mlp_block_q_bf16h,
                  fbq.mlp_block_q_bf16h_plain, x, (qm, qmkw), {})
        for bf16_gelu in (False, True):
            compare_q(fbq, f"mlp_block_q_var bf16_gelu={bf16_gelu} {tag}", fbq.mlp_block_q_var,
                      fbq.mlp_block_q_var_plain, x, (qm, qmkw), {"bf16_gelu": bf16_gelu},
                      quant=fbq.quant_rows_recip)
    # the int8 core at both sides of its key buckets, and the variant's
    # wgmma core on its long route
    for sb in (50, 64, 65, 77, 128, 129, 224, 225, 256):
        qkv = torch.randn(2, sb, 3 * d, generator=g).to(device)
        qq_core_check(fbq, qkv, heads)
    xl = torch.randn(2, 400, d, generator=g).to(device, torch.bfloat16)
    compare_q(fbq, "attention_block_q_var B=2 S=400 (the long core)", fbq.attention_block_q_var,
              fbq.attention_block_q_var_plain, xl, (qa, qakw), {"heads": heads},
              quant=fbq.quant_rows_recip)

    # timed at the main path's B=256, beside K3 / K4 on the same x
    b = BATCH
    x = (torch.randn(b, s, d, generator=g) * 0.5).to(device, torch.bfloat16)
    rows = {}
    sk = {}
    want = fbq.attention_block_qq(x, *qa, heads=heads, **qakw, scratch=sk)
    qkv = sk["qkv"].clone()
    recip, div = fbq.quant_rows_recip, fbq.quant_rows
    timed = {  # name: (kernel, twin, work, source, its check at this shape)
        "attention_block_qq": (
            lambda: fbq.attention_block_qq(x, *qa, heads=heads, **qakw),
            lambda: fbq.attention_block_qq_plain(x, *qa, heads=heads),
            qq_work(b, s, d, heads), "fused_block_q.cu",
            lambda: kb_compare(fbq, "attention_block_qq (timed)", fbq.attention_block_qq,
                               fbq.attention_block_qq_plain, x, (qa, qakw), {"heads": heads},
                               div, True, code_bars=False)),
        "attention_qq_core": (
            lambda: fbq.attention_qq_core(qkv, heads),
            lambda: fbq.attention_qq_core_plain(qkv, heads, torch.bfloat16),
            qq_core_work(b, s, d, heads), "attention_qq.cuh",
            lambda: qq_core_check(fbq, qkv, heads)),
        "attention_block_q_var": (
            lambda: fbq.attention_block_q_var(x, *qa, heads=heads, **qakw),
            lambda: fbq.attention_block_q_var_plain(x, *qa, heads=heads),
            attention_block_work(b, s, d, weights="int8"), "fused_block_q.cu",
            lambda: kb_compare(fbq, "attention_block_q_var (timed)", fbq.attention_block_q_var,
                               fbq.attention_block_q_var_plain, x, (qa, qakw), {"heads": heads},
                               recip, True)),
        "mlp_block_q_bf16h": (
            lambda: fbq.mlp_block_q_bf16h(x, *qm, **qmkw),
            lambda: fbq.mlp_block_q_bf16h_plain(x, *qm),
            mlp_block_work(b, s, d, 4 * d, weights="int8"), "fused_block_q.cu",
            lambda: kb_compare(fbq, "mlp_block_q_bf16h (timed)", fbq.mlp_block_q_bf16h,
                               fbq.mlp_block_q_bf16h_plain, x, (qm, qmkw), {}, div, False)),
        "mlp_block_q_var": (
            lambda: fbq.mlp_block_q_var(x, *qm, **qmkw),
            lambda: fbq.mlp_block_q_var_plain(x, *qm),
            mlp_block_work(b, s, d, 4 * d, weights="int8"), "fused_block_q.cu",
            lambda: kb_compare(fbq, "mlp_block_q_var (timed)", fbq.mlp_block_q_var,
                               fbq.mlp_block_q_var_plain, x, (qm, qmkw), {}, recip, False)),
        "mlp_block_q_var_bf16_gelu": (
            lambda: fbq.mlp_block_q_var(x, *qm, bf16_gelu=True, **qmkw),
            lambda: fbq.mlp_block_q_var_plain(x, *qm, bf16_gelu=True),
            mlp_block_work(b, s, d, 4 * d, weights="int8"), "fused_block_q.cu",
            lambda: kb_compare(fbq, "mlp_block_q_var bf16_gelu (timed)", fbq.mlp_block_q_var,
                               fbq.mlp_block_q_var_plain, x, (qm, qmkw), {"bf16_gelu": True},
                               recip, False)),
    }
    base = {"attention": cuda_ms(lambda: fbq.attention_block_q(x, *qa, heads=heads, **qakw)),
            "mlp": cuda_ms(lambda: fbq.mlp_block_q(x, *qm, **qmkw))}
    for name, (kern, plain, work, src, compare) in timed.items():
        err = compare()
        bound_ms, bound_by = bound(*work)
        rows[name] = {"name": name, "case": f"KB ViT-B/16 B={b} S={s} D={d} H={heads}",
                      "route": "cuda", "source": f"debias_vision_lang_torch/csrc/{src}",
                      "replaces": KB_REPLACES[name], "launches": None, "max_abs_err": err,
                      "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain, iters=3),
                      "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        r = rows[name]
        k = base["attention" if "attention" in name else "mlp"]
        print(f"time {name} B={b} S={s} D={d}: kernel {r['ms']:.4f} ms (K3 / K4 beside it "
              f"{k:.4f} ms, {r['ms'] / k:.3f}x), plain twin {r['plain_ms']:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}; the kernel at {bound_ms / r['ms']:.1%} of it) "
              f"({card})")
    del x, qkv, want
    torch.cuda.empty_cache()
    return rows


def kb_int8_phase(model, card, device):
    """Phase 23: KB (a) 1-4 -- each entry against its twin and timed (
    ``kb_checks``), then the scripts' towers on the phase-4 model's
    resblocks quantized by ``quantize_resblocks``: 12 attention halves
    through K3, qq and the variant, 12 MLP halves through K4, bf16h and the
    variant at both gelus, at B=256 on the scripts' inputs; each tower's
    launches counted (12 per entry; 12 int8 cores inside the qq tower), its
    cosine against the K3 / K4 tower printed (a finding, not a gate) and
    its ms beside the baseline's.  Returns (kernels-line rows, wall)."""
    import torch
    from debias_vision_lang_torch.ops import fused_block as fb
    from debias_vision_lang_torch.ops import fused_block_q as fbq
    from debias_vision_lang_torch.ops.quant import quantize_resblocks

    t_phase = time.perf_counter()
    rows = kb_checks(fbq, device, card)
    walls = {"kernels": time.perf_counter() - t_phase}
    t = time.perf_counter()
    blocks = quantize_resblocks(model.clip.visual.resblocks)
    x0 = kb_inputs(BATCH, n=1)[0]
    towers = {kind: kb_int8_tower(fbq, blocks, kind) for kind in KB_KINDS}
    with torch.no_grad():
        outs, launches = {}, {}
        for kind, run in towers.items():
            reset_all(fb, fbq)
            outs[kind] = run(x0)
            torch.cuda.synchronize()
            launches[kind] = nonzero({**fbq.LAUNCHES, **fbq.KB_LAUNCHES})
            check(bool(torch.isfinite(outs[kind].float()).all()), f"phase 23: {kind} tower "
                  f"not finite")
            if kind == "bf16h":  # D = 768: every up product on the TMA-store GEMM
                check(fbq.BF16H_ROUTES == {"tma": LAYERS, "gemm": 0},
                      f"phase 23: the bf16h tower's routes {fbq.BF16H_ROUTES}")
            if kind in ("mlp_var", "mlp_var_bf16_gelu"):  # LayerNorm and quantize in one pass
                check(fbq.VAR_ROUTES == {"ln": LAYERS, "gemm": 0},
                      f"phase 23: the {kind} tower's routes {fbq.VAR_ROUTES}")
        want = {"k3": {"attention_block_q": LAYERS}, "k4": {"mlp_block_q": LAYERS},
                "qq": {"attention_block_qq": LAYERS, "attention_qq_core": LAYERS},
                "attn_var": {"attention_block_q_var": LAYERS},
                "bf16h": {"mlp_block_q_bf16h": LAYERS}, "mlp_var": {"mlp_block_q_var": LAYERS},
                "mlp_var_bf16_gelu": {"mlp_block_q_var_bf16_gelu": LAYERS}}
        print(f"phase 23 tower launches: {launches}")
        check(launches == want, f"phase 23: tower launches {launches}, expected {want}")
        for kind in ("qq", "attn_var", "bf16h", "mlp_var", "mlp_var_bf16_gelu"):
            base = "k3" if KB_KINDS[kind][1] else "k4"
            cos = cosine(outs[kind].float(), outs[base].float())
            ms = cuda_ms(lambda: towers[kind](x0), iters=3)
            ms_base = cuda_ms(lambda: towers[base](x0), iters=3)
            print(f"phase 23 {kind} tower, {LAYERS} {KB_KINDS[kind][0]} at B={BATCH}: cosine "
                  f"{cos:.7f} against the {base.upper()} tower (a finding, not a gate); "
                  f"{ms:.3f} ms vs {ms_base:.3f} ms ({ms / ms_base:.3f}x) ({card})")
    for name, row in rows.items():
        kind = {"attention_block_qq": "qq", "attention_qq_core": "qq",
                "attention_block_q_var": "attn_var", "mlp_block_q_bf16h": "bf16h",
                "mlp_block_q_var": "mlp_var", "mlp_block_q_var_bf16_gelu": "mlp_var_bf16_gelu"
                }[name]
        row["launches"] = launches[kind][name]
    walls["towers"] = time.perf_counter() - t
    del outs, blocks, x0
    torch.cuda.empty_cache()
    t = time.perf_counter()
    (_, _), (qm, qmkw) = q_block_params(KB_D, device, seed=7)
    xb = kb_inputs(BATCH, n=1)[0]
    mlp_q_launches(fbq, 23, "mlp_block_q_bf16h", lambda: fbq.mlp_block_q_bf16h(xb, *qm, **qmkw),
                   ("ln_quant_rows_kernel", "gemm_s8_tma_kernel", "qgelu_quant_rows_kernel",
                    "gemm_s8_kernel"))
    del xb
    mlp_q_hold(fbq, device, 23, kind="bf16h")
    walls["mlp hold"] = time.perf_counter() - t
    t = time.perf_counter()
    var_launches(fbq, 23, device)
    var_hold(fbq, device, 23, ("var", "var_bf16"))
    text_row = var_row(fbq, device, card, "var")
    walls["kb var hold"] = time.perf_counter() - t
    wall = time.perf_counter() - t_phase
    print(f"phase 23 walls: " + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
          + f"; total {wall:.2f} s ({card})")
    return [rows[k] for k in KB_REPLACES] + [text_row], wall


# ---------------------------------------------------------------------------
# phase 24: K4's F-split (mlp_block_q(fb=), KB (a) 7), KB (a) 5
# (attention_block_opt), the one-call int8 layer of q_layer_fused.py and
# q_ilp4.py's post-P V division
# ---------------------------------------------------------------------------

SPLIT_FB = (1536, 768)  # F / 2 and F / 4 at ViT-B/16: make_fsplit(2) and (4)
FIT_FB = 1024  # mlp_fblock_for_seq's tile at the joint FiT shape (JAX's TPU hybrid path)
FIT_B = 32  # the int8 joint FiT tower's batch of phases 3, 6 and 19
SPLIT_REPLACES = {
    "attention_block_opt": "benchmarks/attn_variants.py:72",
    "mlp_block_q_fsplit": "benchmarks/q_ilp.py:112",
    "mlp_block_q_fsplit FiT": "debias_vision_lang_tpu/ops/fused_block_q.py:427",
    "fused_layer_q": "benchmarks/q_layer_fused.py:168",
    "attention_block_q_postdiv": "benchmarks/q_ilp4.py:125",
}
# the int8 towers of phase 24 (kb_int8_tower's table): F-split MLP halves and
# the post-P V attention halves, beside K4 / K3
SPLIT_KINDS = {"k3": ("attention_block_q", True, {}), "k4": ("mlp_block_q", False, {}),
               "fsplit2": ("mlp_block_q", False, {"fb": SPLIT_FB[0]}),
               "fsplit4": ("mlp_block_q", False, {"fb": SPLIT_FB[1]}),
               "fit_fsplit": ("mlp_block_q", False, {"fb": FIT_FB}),
               "postdiv": ("attention_block_q_postdiv", True, {})}


# the one-call layer's design before its redesign (K3's and K4's launches:
# LayerNorm, then the quantize pass, at both norms; every product on
# gemm_s8_kernel), recorded with ``benchmarks_torch/layer_split.py --root`` on
# the parent checkout: the digests of its output, y, yb and every code and
# scale set in layer_split.py's cases and of its 12-layer tower, and the SASS
# of every kernel of the int8 library.  The redesign adds the persistent QKV
# and down GEMMs (LAYER_NEW) and changes no other kernel.
LAYER_PARENT = "benchmarks_torch/layer_parent.json"
LAYER_NEW = ("gemm_s8_tma_kernel", "gemm_s8_epi_kernel")


def layer_hold(fbq, device):
    """``fused_layer_q`` held to LAYER_PARENT in layer_split.py's cases
    (ViT-B/16 at B=8 and B=256, D=200 H=2 F=800, x and x/16, and the
    12-layer tower; the times are that script's and the kernels line's):
    every output, code and scale bit for bit, yb = bf16(y), every product
    on the s8 GEMM route the same outputs bit for bit; of the int8
    library's kernels none compiled otherwise or gone, only LAYER_NEW (and
    the later MLP_Q_NEW) added."""
    import importlib

    import torch
    from debias_vision_lang_torch.ops import _build

    L = importlib.import_module("benchmarks_torch.layer_split")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), LAYER_PARENT)) as fh:
        parent = json.load(fh)
    off = []

    def each(case, sk):
        other = L.layer_outputs(fbq, case, device, tma=False)
        off.extend(f"{case[0]} {k}" for k in L.KEYS if not torch.equal(sk[k], other[k]))
        if not torch.equal(sk["yb"], sk["y"].to(torch.bfloat16)):
            off.append(f"{case[0]} yb")

    sass = split_sass_digests(L, _build.LIB_PATHS["fused_block_q"])
    found = bool(sass)
    if not found:
        print("phase 24: no cuobjdump found: the int8 library is not held to the parent's SASS")
        sass = dict(parent["sass"], **{n: "" for n in LAYER_NEW + MLP_Q_NEW + VAR_NEW})
    mine = {"outputs": L.flat(L.output_digests(fbq, device, each)), "sass": sass}
    bad = L.S.compare(mine, {"outputs": L.flat(parent["outputs"]), "sass": parent["sass"]},
                      f"the parent design ({LAYER_PARENT})", "phase 24 layer ")
    added, removed = set(sass) - set(parent["sass"]), set(parent["sass"]) - set(sass)
    print(f"phase 24 layer: {len(mine['outputs'])} digests; the s8 GEMM route and yb "
          f"{'agree' if not off else f'DIFFER: {off}'}; added {sorted(added)}")
    check(not bad and not off, f"phase 24: the layer's outputs or the int8 library's kernels "
                               f"differ from the parent design ({bad}; {off})")
    check(not removed and all(any(n in k for n in LAYER_NEW + MLP_Q_NEW + VAR_NEW)
                              for k in added),
          f"phase 24: the int8 library lost {sorted(removed)} or gained {sorted(added)}")
    torch.cuda.empty_cache()


# K4's F-split and KB (a) 2 before their redesign (K4's launches: LayerNorm,
# then the quantize pass; the up product on gemm_s8_kernel; the hidden's pass
# on quant_rows_kernel's tiers; the F-split's down product on the s8 GEMM's
# chunked mode), recorded with ``benchmarks_torch/mlp_q_split.py --root`` on
# the parent checkout: the digests of each entry's output, codes, scales and
# rows in that script's cases and of its two 12-layer towers, and the SASS of
# every kernel of the int8 library.  The redesign adds the chunked
# epilogue-warpgroup GEMM and the two 16-byte quantize passes (MLP_Q_NEW)
# and changes no other kernel.
MLP_Q_PARENT = "benchmarks_torch/mlp_q_parent.json"
MLP_Q_NEW = ("gemm_s8_epi_chunk_kernel", "quant_rows_x4_kernel", "qgelu_quant_rows_kernel")
# the chunked down product's GEMM (one instantiation): s8 wgmma, TMA loads
# and TMA stores
SASS_PER_KERNEL_MLP_Q = {"fused_block_q": (
    ("gemm_s8_epi_chunk_kernel", ("IGMMA", "UTMALDG", "UTMASTG"), 1),)}


def sass_check_mlp_q(path) -> None:
    """The redesign's kernels in the int8 library's SASS: the chunk GEMM
    holds s8 wgmma, TMA loads and TMA stores (SASS_PER_KERNEL_MLP_Q), and
    none of MLP_Q_NEW holds mma.sync (IMMA. / HMMA.)."""
    funcs = sass_functions(path)
    if funcs is None:
        print("sass: no cuobjdump found: the F-split's and KB (a) 2's kernels not checked")
        return
    sass_check_per_kernel("fused_block_q", path, SASS_PER_KERNEL_MLP_Q)
    mma = [name for name, body in funcs.items() if any(n in name for n in MLP_Q_NEW)
           and (re.search(SASS_OPS["IMMA"], body) or re.search(SASS_OPS["HMMA"], body))]
    check(not mma, f"{mma} hold mma.sync (IMMA. / HMMA.) in their SASS")


def mlp_q_hold(fbq, device, phase, kind=None, shapes=False):
    """``mlp_q_split.py``'s cases of one phase held to MLP_Q_PARENT (their
    times are that script's and the kernels line's): ``kind`` ("fsplit" or
    "bf16h") at ViT-B/16's widths and the FiT shape with its 12-layer tower
    at B=256 (phases 24 and 23), or (``shapes``) both entries at
    SigLIP-So400m's widths and D = 200 (phase 27).  The script's single
    calls at B=256 (digests of 0.8 GB of rows each) are left to it: every
    fb and width is held here at B=8 or the FiT shape, and B=256 by the
    tower.  Every output, code, scale and row bit for
    bit, the other route (``tma=False``: the products on the s8 GEMM) the
    same; the F-split's routes as ``fsplit_route`` names them; in phase 24 the
    SASS of the int8 library's kernels none compiled otherwise or gone, only
    MLP_Q_NEW (and the one-call layer's LAYER_NEW) added, and the new GEMM's
    instructions (``sass_check_mlp_q``)."""
    import importlib

    import torch
    from debias_vision_lang_torch.ops import _build

    M = importlib.import_module("benchmarks_torch.mlp_q_split")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), MLP_Q_PARENT)) as fh:
        parent = json.load(fh)
    cases = [c for c in M.CASES if (c[4] != 768) == shapes and (shapes or c[1] == kind)
             and c[2] != M.SPLIT_B]
    off = []

    def each(case, sk):
        other = M.case_outputs(fbq, case, device, tma=False)
        off.extend(f"{case[0]} {k}" for k in M.KEYS[case[1]]
                   if not torch.equal(sk[k], other[k]))

    fbq.reset_launches()
    towers = () if shapes else (kind,)
    mine = M.output_digests(fbq, device, each, cases=cases, towers=towers)
    # each case once on its route and once on the s8 GEMM's; a tower's 12
    # halves at D = 768 on theirs
    split = [c for c in cases if c[1] == "fsplit"]
    n_b16 = len(cases) - len(split)
    want = {"fsplit": {"epi": 0, "gemm": len(split)},
            "bf16h": {"tma": n_b16 + M.TOWER_LAYERS * ("bf16h" in towers), "gemm": n_b16}}
    for c in split:
        want["fsplit"][fbq.fsplit_route(c[4], c[6])] += 1
    if "fsplit" in towers:
        want["fsplit"][fbq.fsplit_route(768, M.TOWER_FB)] += M.TOWER_LAYERS
    got = {"fsplit": dict(fbq.FSPLIT_ROUTES), "bf16h": dict(fbq.BF16H_ROUTES)}
    theirs = {k: v for k, v in parent["outputs"].items() if k in mine}
    sass = parent["sass"]
    if phase == 24:
        sass = split_sass_digests(M, _build.LIB_PATHS["fused_block_q"]) or dict(
            parent["sass"], **{n: "" for n in MLP_Q_NEW + VAR_NEW})
    bad = M.S.compare({"outputs": M.flat(mine), "sass": sass},
                      {"outputs": M.flat(theirs), "sass": parent["sass"]},
                      f"the parent design ({MLP_Q_PARENT})", f"phase {phase} mlp ")
    print(f"phase {phase} mlp: {len(M.flat(mine))} digests of {len(cases)} cases; the s8 GEMM "
          f"route {'agrees' if not off else f'DIFFERS: {off}'}; routes {got} (expected {want})")
    check(not bad and not off and len(theirs) == len(mine),
          f"phase {phase}: the F-split's or KB (a) 2's outputs or the int8 library's kernels "
          f"differ from the parent design ({bad}; {off})")
    check(got == want, f"phase {phase}: the routes {got}, expected {want}")
    if phase == 24:
        added, removed = set(sass) - set(parent["sass"]), set(parent["sass"]) - set(sass)
        check(not removed and all(any(n in k for n in MLP_Q_NEW + LAYER_NEW + VAR_NEW)
                                  for k in added),
              f"phase 24: the int8 library lost {sorted(removed)} or gained {sorted(added)}")
        sass_check_mlp_q(_build.LIB_PATHS["fused_block_q"])
    torch.cuda.empty_cache()


def mlp_q_launches(fbq, phase, name, fn, want, iters=5, tries=6):
    """One entry's device launches a call (``torch.profiler`` over ``iters``
    calls) against ``want`` (the kernels' names in launch order, by prefix).
    Late in a long process the profiler can lose a profile's events: none at
    all, or a kernel recorded fewer times than the calls made (a run saw two
    of four kernels, each under twice in 5 calls).  Every kernel of these
    entries runs a whole number of times a call, so a count that is not a
    multiple of ``iters`` is a lost event, not a launch: such a profile is
    taken again, up to ``tries`` times, and the check holds the first whole
    one.  A kernel missing from a whole profile fails the check."""
    import importlib

    S = importlib.import_module("benchmarks_torch.tp_slot_split")
    prof = []
    for attempt in range(1, tries + 1):
        prof = S.profiled(fn, iters, tries=3)
        lost = [f"{k} x {n}" for k, _, n in prof if n % iters]
        if prof and not lost:
            break
        print(f"phase {phase} {name}: profile {attempt} of {tries} lost events "
              f"({'; '.join(lost) or 'no kernel recorded'})")
    else:
        print(f"phase {phase} {name}: the profiler lost events in all {tries} profiles; "
              f"launches not checked")
        return
    per = {k: n // iters for k, _, n in prof}
    print(f"phase {phase} {name}: {sum(per.values())} launches a call {per}")
    check(sum(per.values()) == len(want)
          and all(any(k.startswith(w) for k in per) for w in want),
          f"phase {phase} {name}: launches {per}, expected one each of {want}")


# KB (a) 3 and q_ilp4's attention before their redesign (K4's / K3's
# launches: LayerNorm, then the quantize pass of x; the up product writing
# the f32 hidden and its reciprocal quantize pass; the QKV product on
# gemm_s8_kernel and the core dividing by __fdiv_rn), recorded with
# ``benchmarks_torch/kb_var_split.py --root`` on the parent checkout: the
# digests of each entry's output, codes, scales and rows in that script's
# cases and of its three 12-layer towers, and the SASS of every kernel of
# the int8 library.  The redesign adds the one pass's reciprocal mode and
# the core's divide-after instantiations (VAR_NEW) and changes no other
# kernel.
KB_VAR_PARENT = "benchmarks_torch/kb_var_parent.json"
CORE_BUCKETS = (32, 80, 200, 256, 320)  # attention_wgmma.cuh's key buckets
VAR_NEW = ("ln_quant_recip_rows_kernel",) + tuple(
    f"attention_wgmma_kernelILi{nk}ELi0ELi2E" for nk in CORE_BUCKETS)
# the divide-after core (each key bucket at head dims 64 and 128): bf16
# wgmma and TMA loads
SASS_PER_KERNEL_VAR = {"fused_block_q": tuple(
    (f"attention_wgmma_kernelILi{nk}ELi0ELi2E", ("HGMMA", "UTMALDG"), 2) for nk in CORE_BUCKETS)}


def sass_check_var(path) -> None:
    """The redesign's kernels in the int8 library's SASS: each instantiation
    of the divide-after core holds bf16 wgmma and TMA loads
    (SASS_PER_KERNEL_VAR), and none of VAR_NEW holds mma.sync (IMMA. /
    HMMA.)."""
    funcs = sass_functions(path)
    if funcs is None:
        print("sass: no cuobjdump found: KB (a) 3's and q_ilp4's kernels not checked")
        return
    sass_check_per_kernel("fused_block_q", path, SASS_PER_KERNEL_VAR)
    mma = [name for name, body in funcs.items() if any(n in name for n in VAR_NEW)
           and (re.search(SASS_OPS["IMMA"], body) or re.search(SASS_OPS["HMMA"], body))]
    check(not mma, f"{mma} hold mma.sync (IMMA. / HMMA.) in their SASS")


def var_hold(fbq, device, phase, kinds):
    """``kb_var_split.py``'s cases of ``kinds`` held to KB_VAR_PARENT (their
    times are that script's and the kernels line's): the B <= 32 cases
    (ViT-B/16 B=8, x and x/16, the FiT shape, SigLIP-So400m's and D = 200's
    widths) and each kind's 12-layer tower at B=256 (the script's single
    calls at B=256 digest 0.8 GB of rows each and are left to it).  Every
    output, code, scale and row bit for bit, the other route (the launches
    before the redesign) the same; each call counted on its route; the SASS
    of the int8 library's kernels none compiled otherwise or gone, only
    VAR_NEW (and the earlier designs' LAYER_NEW, MLP_Q_NEW) added, and the
    new core's instructions (``sass_check_var``)."""
    import importlib

    import torch
    from debias_vision_lang_torch.ops import _build

    K = importlib.import_module("benchmarks_torch.kb_var_split")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), KB_VAR_PARENT)) as fh:
        parent = json.load(fh)
    cases = [c for c in K.CASES if c[1] in kinds and c[2] <= 32]
    off = []

    def each(case, sk):
        for what, other in K.other_routes(fbq, case, device):
            off.extend(f"{case[0]} {what} {k}" for k in K.KEYS[case[1]]
                       if not torch.equal(sk[k], other[k]))

    fbq.reset_launches()
    mine = K.output_digests(fbq, device, each, cases=cases, towers=kinds)
    var = [c for c in cases if c[1] != "postdiv"]
    n_post = len(cases) - len(var)
    want = {"var": {"ln": len(var) + K.TOWER_LAYERS * sum(k != "postdiv" for k in kinds),
                    "gemm": len(var)},
            "postdiv": {"tma": n_post + K.TOWER_LAYERS * ("postdiv" in kinds),
                        "gemm": n_post}}
    got = {"var": dict(fbq.VAR_ROUTES), "postdiv": dict(fbq.POSTDIV_ROUTES)}
    theirs = {k: v for k, v in parent["outputs"].items() if k in mine}
    sass = split_sass_digests(K, _build.LIB_PATHS["fused_block_q"]) or dict(
        parent["sass"], **{n: "" for n in VAR_NEW})
    bad = K.S.compare({"outputs": K.flat(mine), "sass": sass},
                      {"outputs": K.flat(theirs), "sass": parent["sass"]},
                      f"the parent design ({KB_VAR_PARENT})", f"phase {phase} kb var ")
    added, removed = set(sass) - set(parent["sass"]), set(parent["sass"]) - set(sass)
    print(f"phase {phase} kb var: {len(K.flat(mine))} digests of {len(cases)} cases and "
          f"{len(kinds)} towers; the other route {'agrees' if not off else f'DIFFERS: {off}'}; "
          f"routes {got} (expected {want})")
    check(not bad and not off and len(theirs) == len(mine),
          f"phase {phase}: KB (a) 3's or q_ilp4's outputs or the int8 library's kernels differ "
          f"from the parent design ({bad}; {off})")
    check(got == want, f"phase {phase}: the routes {got}, expected {want}")
    check(not removed and all(any(n in k for n in VAR_NEW) for k in added),
          f"phase {phase}: the int8 library lost {sorted(removed)} or gained {sorted(added)}")
    sass_check_var(_build.LIB_PATHS["fused_block_q"])
    torch.cuda.empty_cache()


def var_launches(fbq, phase, device):
    """The redesigned entries' device launches a call at ViT-B/16 B=256 by
    the profiler: KB (a) 3 (both gelus) four, q_ilp4's attention five."""
    (qa, qakw), (qm, qmkw) = q_block_params(KB_D, device, seed=25)
    xb = kb_inputs(BATCH, n=1)[0]
    if phase == 23:
        for bf16_gelu in (False, True):
            up = "gemm_s8_kernel<7" if bf16_gelu else "gemm_s8_kernel<2"
            mlp_q_launches(fbq, 23, f"mlp_block_q_var bf16_gelu={bf16_gelu}",
                           lambda: fbq.mlp_block_q_var(xb, *qm, bf16_gelu=bf16_gelu, **qmkw),
                           ("ln_quant_recip_rows_kernel", up, "quant_rows_kernel",
                            "gemm_s8_kernel<4"))
    else:
        mlp_q_launches(fbq, 24, "attention_block_q_postdiv",
                       lambda: fbq.attention_block_q_postdiv(xb, *qa, heads=KB_H, **qakw),
                       ("ln_quant_rows_kernel", "gemm_s8_tma_kernel", "attention_wgmma_kernel",
                        "quant_rows_kernel", "gemm_s8_kernel"))
    del xb


def var_row(fbq, device, card, kind):
    """A kernels-line row of a redesigned entry at a shape the towers do not
    run: KB (a) 3 at ViT-B/16's text-tower widths (B=319 S=77 D=512 F=2,048),
    or q_ilp4's
    attention at the int8 joint FiT shape (B=32 S=785: its core on the long
    route), against its twin (``kb_compare``), timed beside it; its launches
    those of the check, on the route it is counted on."""
    import torch

    if kind == "var":
        b, s, d, heads = 319, 77, 512, 8
    else:
        b, s, d, heads = FIT_B, FIT_JOINT_S, KB_D, KB_H
    (qa, qakw), (qm, qmkw) = q_block_params(d, device, seed=31)
    g = torch.Generator().manual_seed(33)
    x = (torch.randn(b, s, d, generator=g) * 0.5).to(device, torch.bfloat16)
    fbq.reset_launches()
    if kind == "var":
        name, case = "mlp_block_q_var", f"KB (a) 3 text-tower widths B={b} S={s} D={d} F={4 * d}"
        err = kb_compare(fbq, f"{name} D={d} (timed)", fbq.mlp_block_q_var,
                         fbq.mlp_block_q_var_plain, x, (qm, qmkw), {}, fbq.quant_rows_recip,
                         False)
        kern, plain = (lambda: fbq.mlp_block_q_var(x, *qm, **qmkw),
                       lambda: fbq.mlp_block_q_var_plain(x, *qm))
        work, replaces = mlp_block_work(b, s, d, 4 * d, weights="int8"), KB_REPLACES[name]
        check(fbq.VAR_ROUTES == {"ln": 1, "gemm": 0},
              f"phase 23: KB (a) 3 at D={d} took {fbq.VAR_ROUTES}")
    else:
        name, case = "attention_block_q_postdiv", f"q_ilp4 FiT joint int8 B={b} S={s} D={d}"
        err = kb_compare(fbq, f"{name} S={s} (timed)", fbq.attention_block_q_postdiv,
                         fbq.attention_block_q_postdiv_plain, x, (qa, qakw), {"heads": heads},
                         fbq.quant_rows, True)
        kern, plain = (lambda: fbq.attention_block_q_postdiv(x, *qa, heads=heads, **qakw),
                       lambda: fbq.attention_block_q_postdiv_plain(x, *qa, heads=heads))
        work, replaces = attention_block_work(b, s, d, weights="int8"), SPLIT_REPLACES[name]
        check(fbq.POSTDIV_ROUTES == {"tma": 1, "gemm": 0} and fbq.CORE_ROUTES["long"] == 1,
              f"phase 24: q_ilp4 at S={s} took {fbq.POSTDIV_ROUTES}, {fbq.CORE_ROUTES}")
    launches = fbq.KB_LAUNCHES[name]
    bound_ms, bound_by = bound(*work)
    row = {"name": name, "case": case, "route": "cuda",
           "source": "debias_vision_lang_torch/csrc/fused_block_q.cu", "replaces": replaces,
           "launches": launches, "max_abs_err": err, "ms": cuda_ms(kern),
           "plain_ms": cuda_ms(plain, iters=3), "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": None}
    print(f"time {name} {case}: kernel {row['ms']:.4f} ms, plain twin {row['plain_ms']:.4f} "
          f"ms, bound {bound_ms:.4f} ms ({bound_by}; the kernel at {bound_ms / row['ms']:.1%} "
          f"of it) ({card})")
    del x
    torch.cuda.empty_cache()
    return row


def layer_work(b, s, d, f):
    """The one-call int8 layer: K3's and K4's operations; x read and the
    output written once (y stays between the halves), both halves' weights,
    scales and biases read once."""
    a_ops, a_bytes = attention_block_work(b, s, d, weights="int8")
    m_ops, m_bytes = mlp_block_work(b, s, d, f, weights="int8")
    ops = {k: a_ops.get(k, 0) + m_ops.get(k, 0) for k in set(a_ops) | set(m_ops)}
    return ops, a_bytes + m_bytes - 2 * b * s * d * 2


def fsplit_own(fbq, x, mlp, fbv):
    """K4's F-split last step on the kernel's own hidden rows (whose codes
    the compare checks are quant_rows of them, chunk by chunk): (x + b2) +
    the chunks' f32 sum."""
    def own(sk):
        b, s = x.shape[:2]
        part = fbq.fsplit_down(sk["h"].reshape(b, s, -1), mlp[5], mlp[6], fbv)[0]
        return (x.float() + mlp[7].float()) + part
    return own


def layer_compare(fbq, name, x, qa, qakw, qm, qmkw, heads):
    """``fused_layer_q`` against its twin: every int8 code of both halves
    the quantization of the kernel's own rows (the layer normalises and
    quantizes in one pass and writes no LayerNorm rows: those of its codes
    are held to K3's LayerNorm rows of x and K4's of its own bf16 y, the
    same kernel's rows bit for bit); the attention half's codes off the
    twin's, and the MLP half's off K4's twin's run on bf16 of the kernel's
    own y (a flipped attention code moves its whole row of y, and so that
    row's MLP codes), under phase 6's bars (``compare_q``'s: each set's
    largest difference, the MLP half's x codes at the xq bar, the share over
    each half's codes); the f32 y bit-equal to x + (deq + bo) of the
    kernel's own attention codes, its yb bf16(y); the output within 1 bf16
    ulp of the twin's last step on the kernel's own y and hidden codes, and
    of the twin's own output unless some code differs from the twin's.
    Returns the largest output difference from the twin."""
    import torch

    sk, sr, sm, s3, s4 = {}, {}, {}, {}, {}
    got = fbq.fused_layer_q(x, *qa, *qm, heads=heads, **qakw, **qmkw, scratch=sk)
    ref = fbq.fused_layer_q_plain(x, *qa, *qm, heads=heads, scratch=sr)
    fbq.mlp_block_q_plain(sk["y"].to(x.dtype), *qm, scratch=sm)
    sm = {"yq": sm["xq"], "hq": sm["hq"]}
    if "xn" not in sk:  # the card: K3's and K4's LayerNorm rows of the same inputs
        fbq.attention_block_q(x, *qa, heads=heads, **qakw, scratch=s3)
        fbq.mlp_block_q(sk["y"].to(x.dtype), *qm, **qmkw, scratch=s4)
        sk = {**sk, "xn": s3["xn"], "yn": s4["xn"]}
        check(torch.equal(sk["yb"], sk["y"].to(x.dtype)), f"{name}: its yb is not bf16(y)")
    n_diff = 0
    for half, sets, twin in (("attention", (("xq", "xn", "xs"), ("aq", "attn", "as")), sr),
                             ("MLP", (("yq", "yn", "ys"), ("hq", "h", "hs")), sm)):
        h_diff = h_codes = 0
        for codes, rows, scales in sets:
            q, sc = fbq.quant_rows(sk[rows])
            check(torch.equal(q, sk[codes]) and torch.equal(sc, sk[scales]),
                  f"{name}: its {codes} codes are not the quantization of its own {rows} rows")
            diff = (sk[codes].int() - twin[codes].int()).abs()
            h_diff += int(diff.ne(0).sum())
            h_codes += diff.numel()
            bar = CODE_DIFF_MAX["xq" if codes == "yq" else codes]
            print(f"  {name} {codes}: {diff.ne(0).float().mean().item():.3e} differ from the "
                  f"twin's, max |diff| {diff.max().item()} (bar {bar})")
            check(diff.max().item() <= bar, f"{name}: {codes} codes off by {diff.max().item()}")
        print(f"  {name} {half} half: {h_diff / h_codes:.3e} of its codes differ (bar "
              f"{CODE_SHARE_MAX})")
        check(h_diff / h_codes <= CODE_SHARE_MAX, f"{name}: {half} codes drift from the twin's")
        n_diff += h_diff
    y = x.float() + (fbq.dot_q(sk["aq"], sk["as"], qa[5], qa[6]) + qa[7].float())
    y_err = (sk["y"] - y).abs().max().item()
    own = ((sk["y"] + qm[7].float()) + fbq.dot_q(sk["hq"], sk["hs"], qm[5], qm[6])).to(x.dtype)
    own_err = (got.float() - own.float()).abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    tol = ulp_bf16(ref.float().abs().max().item())
    print(f"kernel {name}: max_abs_err {err} (1 bf16 ulp of max |twin| {tol}); f32 y vs x + "
          f"(deq + bo) of its own codes {y_err}; vs the twin's last step on its own y and codes "
          f"{own_err}; {n_diff} codes off the twin's")
    check(y_err == 0, f"{name}: its f32 y is not x + (deq + bo) of its own attention codes")
    check(math.isfinite(err) and own_err <= ulp_bf16(own.float().abs().max().item()),
          f"{name}: the output is off the twin's last step on its own codes")
    check(err <= tol or n_diff > 0, f"{name}: past 1 bf16 ulp of its twin with the twin's codes")
    return err


def split_checks(fb, fbq, device, card):
    """Each phase-24 entry against its twin at B=8 S=197 D=768 H=12 (x and
    x/16), K4's F-split at the FiT shape and its card refusal, then each
    timed at B=256 beside K1, K4 or K3 + K4 (the FiT split at B=32 S=785
    beside K4).  Returns the kernels-line rows (launches set by the caller)."""
    import torch

    d, heads, s, b, f = KB_D, KB_H, KB_S, KB_CHECK_B, KB_F
    (ls, lb, wqkv, bqkv, wo, bo), _ = block_params(d, device, seed=24)
    wq, bq = fb.prescale_qkv(wqkv, bqkv, d, heads)
    opt_args = (ls, lb, wq, bq, wo, bo)
    (qa, qakw), (qm, qmkw) = q_block_params(d, device, seed=25)
    g = torch.Generator().manual_seed(24)
    for scale in (1.0, 1 / 16):
        x = (torch.randn(b, s, d, generator=g) * scale).to(device, torch.bfloat16)
        tag = f"B={b} S={s} D={d} x~N(0,{scale}^2)"
        compare_bf16(f"attention_block_opt {tag}", x,
                     fb.attention_block_opt(x, *opt_args, heads=heads),
                     fb.attention_block_opt_plain(x, *opt_args, heads=heads))
        for fbv in SPLIT_FB:
            for act in ("quick_gelu", "gelu"):
                compare_q(fbq, f"mlp_block_q fb={fbv} {act} {tag}", fbq.mlp_block_q,
                          fbq.mlp_block_q_plain, x, (qm, qmkw), {"fb": fbv, "act_kind": act})
        layer_compare(fbq, f"fused_layer_q {tag}", x, qa, qakw, qm, qmkw, heads)
        compare_q(fbq, f"attention_block_q_postdiv {tag}", fbq.attention_block_q_postdiv,
                  fbq.attention_block_q_postdiv_plain, x, (qa, qakw), {"heads": heads})
    # the long core past 320 keys on both attention entries
    xl = torch.randn(2, 400, d, generator=g).to(device, torch.bfloat16)
    compare_bf16("attention_block_opt B=2 S=400 (the long core)", xl,
                 fb.attention_block_opt(xl, *opt_args, heads=heads),
                 fb.attention_block_opt_plain(xl, *opt_args, heads=heads))
    # K4's F-split at the int8 joint FiT shape, at JAX's tile there
    xf = (torch.randn(FIT_B, FIT_JOINT_S, d, generator=g) * 0.5).to(device, torch.bfloat16)
    fit_err = kb_compare(fbq, f"mlp_block_q fb={FIT_FB} FiT B={FIT_B} S={FIT_JOINT_S}",
                         fbq.mlp_block_q, fbq.mlp_block_q_plain, xf, (qm, qmkw),
                         {"fb": FIT_FB}, fbq.quant_rows, False,
                         own_step=fsplit_own(fbq, xf, qm, FIT_FB))
    # an F-tile off the s8 GEMM's K step computes: each chunk padded to 256
    fbq.reset_launches()
    compare_q(fbq, f"mlp_block_q fb=192 (chunks padded to 256) {tag}", fbq.mlp_block_q,
              fbq.mlp_block_q_plain, x, (qm, qmkw), {"fb": 192})
    check(fbq.KB_LAUNCHES["mlp_block_q_fsplit"] == 1 and sum(fbq.LAUNCHES.values()) == 0,
          f"mlp_block_q fb=192 launched {fbq.KB_LAUNCHES} {fbq.LAUNCHES}")

    # timed at the main path's B=256 (the FiT split at B=32 S=785)
    b = BATCH
    x = (torch.randn(b, s, d, generator=g) * 0.5).to(device, torch.bfloat16)
    k3k4 = lambda: fbq.mlp_block_q(fbq.attention_block_q(x, *qa, heads=heads, **qakw),
                                   *qm, **qmkw)
    base = {"K1": cuda_ms(lambda: fb.attention_block(x, ls, lb, wqkv, bqkv, wo, bo,
                                                     heads=heads)),
            "K3": cuda_ms(lambda: fbq.attention_block_q(x, *qa, heads=heads, **qakw)),
            "K4": cuda_ms(lambda: fbq.mlp_block_q(x, *qm, **qmkw)),
            "K3 + K4": cuda_ms(k3k4),
            "K4 FiT": cuda_ms(lambda: fbq.mlp_block_q(xf, *qm, **qmkw))}
    vit = f"ViT-B/16 B={b} S={s} D={d} H={heads}"
    div = fbq.quant_rows
    timed = {  # key: (name, case, kernel, twin, work, source, baseline, its check here)
        "attention_block_opt": (
            "attention_block_opt", vit,
            lambda: fb.attention_block_opt(x, *opt_args, heads=heads),
            lambda: fb.attention_block_opt_plain(x, *opt_args, heads=heads),
            attention_block_work(b, s, d), "fused_block.cu", "K1",
            lambda: compare_bf16(f"attention_block_opt (timed)", x,
                                 fb.attention_block_opt(x, *opt_args, heads=heads),
                                 fb.attention_block_opt_plain(x, *opt_args, heads=heads))),
        **{f"fsplit fb={fbv}": (
            "mlp_block_q_fsplit", f"{vit} fb={fbv}",
            lambda fbv=fbv: fbq.mlp_block_q(x, *qm, fb=fbv, **qmkw),
            lambda fbv=fbv: fbq.mlp_block_q_plain(x, *qm, fb=fbv),
            mlp_block_work(b, s, d, f, weights="int8"), "fused_block_q.cu", "K4",
            lambda fbv=fbv: kb_compare(fbq, f"mlp_block_q fb={fbv} (timed)", fbq.mlp_block_q,
                                       fbq.mlp_block_q_plain, x, (qm, qmkw), {"fb": fbv}, div,
                                       False, own_step=fsplit_own(fbq, x, qm, fbv)))
           for fbv in SPLIT_FB},
        "fsplit FiT": (
            "mlp_block_q_fsplit", f"FiT joint int8 B={FIT_B} S={FIT_JOINT_S} D={d} fb={FIT_FB}",
            lambda: fbq.mlp_block_q(xf, *qm, fb=FIT_FB, **qmkw),
            lambda: fbq.mlp_block_q_plain(xf, *qm, fb=FIT_FB),
            mlp_block_work(FIT_B, FIT_JOINT_S, d, f, weights="int8"), "fused_block_q.cu",
            "K4 FiT", lambda: fit_err),
        "fused_layer_q": (
            "fused_layer_q", vit,
            lambda: fbq.fused_layer_q(x, *qa, *qm, heads=heads, **qakw, **qmkw),
            lambda: fbq.fused_layer_q_plain(x, *qa, *qm, heads=heads),
            layer_work(b, s, d, f), "fused_block_q.cu", "K3 + K4",
            lambda: layer_compare(fbq, "fused_layer_q (timed)", x, qa, qakw, qm, qmkw, heads)),
        "attention_block_q_postdiv": (
            "attention_block_q_postdiv", vit,
            lambda: fbq.attention_block_q_postdiv(x, *qa, heads=heads, **qakw),
            lambda: fbq.attention_block_q_postdiv_plain(x, *qa, heads=heads),
            attention_block_work(b, s, d, weights="int8"), "fused_block_q.cu", "K3",
            lambda: kb_compare(fbq, "attention_block_q_postdiv (timed)",
                               fbq.attention_block_q_postdiv,
                               fbq.attention_block_q_postdiv_plain, x, (qa, qakw),
                               {"heads": heads}, div, True)),
    }
    rows = {}
    for key, (name, case, kern, plain, work, src, against, compare) in timed.items():
        err = compare()
        bound_ms, bound_by = bound(*work)
        replaces = SPLIT_REPLACES["mlp_block_q_fsplit FiT" if key == "fsplit FiT" else name]
        rows[key] = {"name": name, "case": case, "route": "cuda",
                     "source": f"debias_vision_lang_torch/csrc/{src}", "replaces": replaces,
                     "launches": None, "max_abs_err": err, "ms": cuda_ms(kern),
                     "plain_ms": cuda_ms(plain, iters=3), "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None}
        r, k = rows[key], base[against]
        print(f"time {name} {case}: kernel {r['ms']:.4f} ms ({against} beside it {k:.4f} ms, "
              f"{r['ms'] / k:.3f}x), plain twin {r['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}; the kernel at {bound_ms / r['ms']:.1%} of it) ({card})")
    # where the split's time goes: K4 and the split by sub-kernel (the
    # chunked down GEMM runs one block per SM), and the layer's
    m = b * s
    mlp_ops = {"up GEMM": 2 * m * d * f, "down GEMM": 2 * m * d * f}
    for fbv in (None, *SPLIT_FB):
        subkernel_split(f"mlp_block_q fb={fbv or f} B={b}",
                        lambda: fbq.mlp_block_q(x, *qm, fb=fbv, **qmkw), mlp_ops, card,
                        kind="int8")
    subkernel_split(f"fused_layer_q B={b}",
                    lambda: fbq.fused_layer_q(x, *qa, *qm, heads=heads, **qakw, **qmkw),
                    {"QKV GEMM": 2 * m * d * 3 * d, "out GEMM": 2 * m * d * d, **mlp_ops}, card,
                    kind="int8", rename={"quantize x": "quantize attn"})
    del x, xf
    torch.cuda.empty_cache()
    return rows


def split_phase(model, card, device):
    """Phase 24: K4's F-split, KB (a) 5, the one-call int8 layer and q_ilp4's
    post-P V division -- each against its twin and timed (``split_checks``),
    then the scripts' 12-layer towers on the phase-4 model's resblocks at
    B=256 on their inputs: the attention halves through K1 and KB (a) 5
    (bf16, prescale_qkv on each block's weights), the int8 MLP halves
    through K4 and the split at fb = 1536 and 768, the int8 layers through
    K3 then K4 and through the one-call layer, the int8 attention halves
    through K3 and the post-P V division, and the MLP halves at the FiT
    shape (B=32 S=785) through K4 and fb = 1024; each tower's launches
    checked (12 per entry), its cosine against the baseline tower printed
    (a finding, not a gate) and its ms beside it.  Returns (kernels-line
    rows, wall)."""
    import torch
    from debias_vision_lang_torch.ops import fused_block as fb
    from debias_vision_lang_torch.ops import fused_block_q as fbq
    from debias_vision_lang_torch.ops.quant import quantize_resblocks

    t_phase = time.perf_counter()
    rows = split_checks(fb, fbq, device, card)
    walls = {"kernels": time.perf_counter() - t_phase}
    t = time.perf_counter()
    layer_hold(fbq, device)
    walls["layer hold"] = time.perf_counter() - t
    t = time.perf_counter()
    (_, _), (qm, qmkw) = q_block_params(KB_D, device, seed=25)
    xb = kb_inputs(BATCH, n=1)[0]
    for fbv, quant in ((SPLIT_FB[0], "quant_rows_x4_kernel"), (SPLIT_FB[1], "quant_rows_kernel")):
        down = ("gemm_s8_epi_chunk_kernel" if fbq.fsplit_route(KB_D, fbv) == "epi"
                else "gemm_s8_kernel")
        mlp_q_launches(fbq, 24, f"mlp_block_q(fb={fbv})",
                       lambda fbv=fbv: fbq.mlp_block_q(xb, *qm, fb=fbv, **qmkw),
                       ("ln_quant_rows_kernel", "gemm_s8_kernel", quant, down))
    del xb
    mlp_q_hold(fbq, device, 24, kind="fsplit")
    walls["mlp hold"] = time.perf_counter() - t
    t = time.perf_counter()
    var_launches(fbq, 24, device)
    var_hold(fbq, device, 24, ("postdiv",))
    fit_row = var_row(fbq, device, card, "postdiv")
    walls["kb var hold"] = time.perf_counter() - t
    t = time.perf_counter()
    res = model.clip.visual.resblocks
    d, heads = KB_D, KB_H
    opt_w = [fb.prescale_qkv(blk.attn.wqkv.detach(), blk.attn.bqkv.detach(), d, heads)
             for blk in res]
    blocks = quantize_resblocks(res)

    def bf16_tower(opt):
        def run(x):
            for blk, (wq, bq) in zip(res, opt_w):
                a = blk.attn
                if opt:
                    x = fb.attention_block_opt(x, blk.ln_1.scale, blk.ln_1.bias, wq, bq, a.wo,
                                               a.bo, heads=heads)
                else:
                    x = fb.attention_block(x, blk.ln_1.scale, blk.ln_1.bias, a.wqkv, a.bqkv,
                                           a.wo, a.bo, heads=heads)
            return x
        return run

    def layer_tower(one_call):
        def run(x):
            for blk in blocks:
                if one_call:
                    x = fbq.fused_layer_q(
                        x, blk.ln_1.scale, blk.ln_1.bias, blk.wqkv.q, blk.wqkv.scale, blk.bqkv,
                        blk.wo.q, blk.wo.scale, blk.bo, blk.ln_2.scale, blk.ln_2.bias,
                        blk.w1.q, blk.w1.scale, blk.b1, blk.w2.q, blk.w2.scale, blk.b2,
                        heads=heads, wqkv_qt=blk.wqkv.qt, wo_qt=blk.wo.qt, w1_qt=blk.w1.qt,
                        w2_qt=blk.w2.qt)
                else:
                    x = fbq.fused_resblock_q(blk, x, heads)
            return x
        return run

    x0 = kb_inputs(BATCH, n=1)[0]
    rng = np.random.default_rng(24)
    xf = torch.from_numpy((rng.normal(size=(FIT_B, FIT_JOINT_S, d)) * 0.5).astype(np.float32)
                          ).to(device, torch.bfloat16)
    towers = {  # kind: (x -> out, input, baseline kind, launches expected)
        "k1": (bf16_tower(False), x0, None, {"attention_block": LAYERS}),
        "opt": (bf16_tower(True), x0, "k1", {"attention_block_opt": LAYERS}),
        "k4": (kb_int8_tower(fbq, blocks, "k4", kinds=SPLIT_KINDS), x0, None,
               {"mlp_block_q": LAYERS}),
        "fsplit2": (kb_int8_tower(fbq, blocks, "fsplit2", kinds=SPLIT_KINDS), x0, "k4",
                    {"mlp_block_q_fsplit": LAYERS}),
        "fsplit4": (kb_int8_tower(fbq, blocks, "fsplit4", kinds=SPLIT_KINDS), x0, "k4",
                    {"mlp_block_q_fsplit": LAYERS}),
        "k3k4": (layer_tower(False), x0, None,
                 {"attention_block_q": LAYERS, "mlp_block_q": LAYERS}),
        "layer": (layer_tower(True), x0, "k3k4", {"fused_layer_q": LAYERS}),
        "k3": (kb_int8_tower(fbq, blocks, "k3", kinds=SPLIT_KINDS), x0, None,
               {"attention_block_q": LAYERS}),
        "postdiv": (kb_int8_tower(fbq, blocks, "postdiv", kinds=SPLIT_KINDS), x0, "k3",
                    {"attention_block_q_postdiv": LAYERS}),
        "k4_fit": (kb_int8_tower(fbq, blocks, "k4", kinds=SPLIT_KINDS), xf, None,
                   {"mlp_block_q": LAYERS}),
        "fit_fsplit": (kb_int8_tower(fbq, blocks, "fit_fsplit", kinds=SPLIT_KINDS), xf,
                       "k4_fit", {"mlp_block_q_fsplit": LAYERS}),
    }
    with torch.no_grad():
        outs, launches = {}, {}
        for kind, (run, x, _, want) in towers.items():
            reset_all(fb, fbq)
            outs[kind] = run(x)
            torch.cuda.synchronize()
            launches[kind] = nonzero({**fb.LAUNCHES, **fb.KB_LAUNCHES, **fbq.LAUNCHES,
                                      **fbq.KB_LAUNCHES})
            check(bool(torch.isfinite(outs[kind].float()).all()),
                  f"phase 24: {kind} tower not finite")
            check(launches[kind] == want,
                  f"phase 24: {kind} tower launches {launches[kind]}, expected {want}")
            if kind == "layer":  # D = 768: the QKV and down products on the persistent GEMMs
                check(fbq.LAYER_ROUTES == {"tma": LAYERS, "qkv": 0, "gemm": 0},
                      f"phase 24: the layer tower's routes {fbq.LAYER_ROUTES}")
            if kind == "postdiv":  # the one pass, the TMA-store QKV GEMM, the divide-after core
                check(fbq.POSTDIV_ROUTES == {"tma": LAYERS, "gemm": 0},
                      f"phase 24: the postdiv tower's routes {fbq.POSTDIV_ROUTES}")
            if kind in ("fsplit2", "fsplit4", "fit_fsplit"):  # each call on fsplit_route's
                route = fbq.fsplit_route(KB_D, SPLIT_KINDS[kind][2]["fb"])
                check(fbq.FSPLIT_ROUTES == {"epi": 0, "gemm": 0, route: LAYERS},
                      f"phase 24: the {kind} tower's routes {fbq.FSPLIT_ROUTES}")
        print(f"phase 24 tower launches: {launches}")
        for kind, (run, x, base, _) in towers.items():
            if base is None:
                continue
            cos = cosine(outs[kind].float(), outs[base].float())
            ms = cuda_ms(lambda: run(x), iters=3)
            ms_base = cuda_ms(lambda: towers[base][0](x), iters=3)
            print(f"phase 24 {kind} tower, {LAYERS} layers at B={x.shape[0]} S={x.shape[1]}: "
                  f"cosine {cos:.7f} against the {base} tower (a finding, not a gate); "
                  f"{ms:.3f} ms vs {ms_base:.3f} ms ({ms / ms_base:.3f}x) ({card})")
    for key, tower in (("attention_block_opt", "opt"), (f"fsplit fb={SPLIT_FB[0]}", "fsplit2"),
                       (f"fsplit fb={SPLIT_FB[1]}", "fsplit4"), ("fsplit FiT", "fit_fsplit"),
                       ("fused_layer_q", "layer"), ("attention_block_q_postdiv", "postdiv")):
        rows[key]["launches"] = launches[tower][rows[key]["name"]]
    walls["towers"] = time.perf_counter() - t
    del outs, blocks, x0, xf, opt_w
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"phase 24 walls: " + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
          + f"; total {wall:.2f} s ({card})")
    return list(rows.values()) + [fit_row], wall


# ---------------------------------------------------------------------------
# phase 25: benchmarks/q_attribution.py's MXU-only and VPU-only int8 blocks
# (KB (c)): each block with one side stubbed out, to time how much of K3 /
# K4 is product and how much is elementwise chain
# ---------------------------------------------------------------------------

ATTR_B = 512  # the script's ATTR_BATCH: its towers' batch
ATTR_REPLACES = {
    "mlp_block_q_attr_mxu": "benchmarks/q_attribution.py:106",
    "mlp_block_q_attr_vpu": "benchmarks/q_attribution.py:106",
    "attention_block_q_attr_mxu": "benchmarks/q_attribution.py:196",
    "attention_block_q_attr_vpu": "benchmarks/q_attribution.py:196",
}
ATTR_ENTRIES = {"mlp": "mlp_block_q", "attn": "attention_block_q"}
# the script's six towers (kb_int8_tower's table), and the counter each
# launch lands in: "full" is K3 / K4 (LAUNCHES), the others KB_LAUNCHES
ATTR_KINDS = {f"{blk}_{mode}": (f"{entry}_attr", blk == "attn", {"mode": mode})
              for blk, entry in ATTR_ENTRIES.items() for mode in ("full", "mxu", "vpu")}
ATTR_COUNTERS = {f"{blk}_{mode}": entry if mode == "full" else f"{entry}_attr_{mode}"
                 for blk, entry in ATTR_ENTRIES.items() for mode in ("full", "mxu", "vpu")}
# f32 operations per element of the "vpu" bodies' elementwise chain, as
# the TPU bodies state it: LayerNorm (mean; centre, square, sum; centre,
# scale, shift and bias), a quantize pass (|x|, max, division, rounding, two
# clips), a broadcast product (the code times its scale, the bias), quick_gelu
# (product, exp, sum, division, product), a residual add, and per score of
# the core the scale, max, difference, exp, sum and division
ATTR_VPU_OPS = {"ln": 7, "quant": 6, "bcast": 2, "qgelu": 5, "resid": 1, "score": 6}


# the attribution's own sub-kernels by profiler label (``subkernel_split``)
ATTR_SPLIT_NAMES = {"gemm_s8_kernel<11>": "up GEMM (int8 out)", "cast_s8_kernel<true>": "cast x",
                    "cast_s8_kernel<false>": "cast attn", "bcast_rows_kernel<0>": "QKV stub",
                    "bcast_rows_kernel<1>": "out stub", "bcast_rows_kernel<2>": "up stub",
                    "bcast_rows_kernel<4>": "down stub", "attention_vpu_core_kernel": "core stub"}


def attr_gemm_ops(block, m, d, f):
    """The int8 operations of each product of a block's "mxu" mode, by split label."""
    if block == "mlp":
        return {"up GEMM (int8 out)": 2 * m * d * f, "down GEMM": 2 * m * d * f}
    return {"QKV GEMM": 2 * m * d * 3 * d, "out GEMM": 2 * m * d * d}


def attr_work(block, mode, b, s, d, f, heads):
    """Operations by type and bytes of one attribution block, the least any
    design must do: "mxu" the block's int8 products (and the attention
    core's Q K^T and P V in bf16), "vpu" its elementwise chain in f32
    (ATTR_VPU_OPS per element of the stubbed shapes); x read and the output
    written once, each parameter the mode reads read once (no weights in
    "vpu", no LayerNorm in "mxu")."""
    m, o = b * s, ATTR_VPU_OPS
    if block == "mlp":
        if mode == "mxu":
            return {"int8": 4 * m * d * f}, 2 * m * d * 2 + 2 * d * f + 2 * (f + d) * 4
        ops = (m * d * (o["ln"] + o["quant"] + o["bcast"] + o["resid"])
               + m * f * (o["bcast"] + o["qgelu"] + o["quant"]))
        return {"f32": ops}, 2 * m * d * 2 + (3 * d + f) * 4
    if mode == "mxu":
        return ({"int8": 2 * m * d * 4 * d, "bf16": 4 * b * heads * s * s * 64},
                2 * m * d * 2 + 4 * d * d + 8 * d * 4)
    ops = (m * d * (o["ln"] + 2 * o["quant"] + o["bcast"] + o["resid"]) + m * 3 * d * o["bcast"]
           + b * heads * s * s * o["score"])
    return {"f32": ops}, 2 * m * d * 2 + 6 * d * 4


def attr_own(fbq, block, mode, x, args, sk):
    """The twin's last step on the kernel's own codes and row scales (the
    out- or down-projection, or its "vpu" broadcast), f32."""
    c, s = ("hq", "hs") if block == "mlp" else ("aq", "as")
    part = (fbq.dot_q(sk[c], sk[s], args[5], args[6]) if mode == "mxu"
            else fbq.bcast_rows(sk[c], sk[s], x.shape[-1]))
    bias = args[7].float()
    return (x.float() + bias) + part if block == "mlp" else x.float() + (part + bias)


def attr_compare(fbq, block, mode, x, params, heads, tag):
    """One attribution block against its twin: its int8 codes the twin's
    conversion of the kernel's own rows, exactly ("mxu": x's static cast,
    the saturating cast of its own attention rows, or of the f32 hidden the
    twin computes from its own x codes, whose up product is exact, with row
    scales 1/16 and 1; "vpu": quant_rows of its own LN output, hidden or
    attention rows); its codes off the twin's under phase 6's bars (the
    "mxu" attention core sums its products in another order than the twin,
    so a bf16 rounding of an attention row now and then lands across an
    integer and its truncated code moves by one); its output bit-equal to
    the twin's last step on its own codes, and, when every code is the
    twin's, within 1 bf16 ulp of the twin's largest magnitude (a code one
    off moves its row's outputs by a dequantized weight of wo, up to ~0.14
    at these weights: past 1 ulp at times).  Returns the largest output
    difference."""
    import torch

    args, qkw = params
    entry = f"{ATTR_ENTRIES[block]}_attr"
    name = f"{entry}_{mode}"
    kern, plain = getattr(fbq, entry), getattr(fbq, f"{entry}_plain")
    kw = {"mode": mode, **({"heads": heads} if block == "attn" else {})}
    sk, sr = {}, {}
    got = kern(x, *args, **kw, **qkw, scratch=sk)
    ref = plain(x, *args, **kw, scratch=sr)
    rows = "h" if block == "mlp" else "attn"
    codes = ("hq", "hs") if block == "mlp" else ("aq", "as")
    if mode == "mxu":
        own = {"xq": fbq.static_q(x)}
        if block == "mlp":
            h = fbq.dot_q(sk["xq"], sk["xs"], args[2], args[3]) + args[4].float()
            own[codes[0]] = fbq.unit_q(h)
        else:
            own[codes[0]] = fbq.unit_q(sk["attn"])
    else:
        own = {"xq": fbq.quant_rows(sk["xn"]), codes[0]: fbq.quant_rows(sk[rows])}
    n_diff = n_codes = 0
    for c, s in (("xq", "xs"), codes):
        q, sc = own[c]
        check(torch.equal(q, sk[c]) and torch.equal(sc.expand_as(sk[s]), sk[s]),
              f"{name}: its {c} codes are not the twin's conversion of its own rows")
        diff = (sk[c].int() - sr[c].int()).abs()
        n_diff, n_codes = n_diff + int(diff.ne(0).sum()), n_codes + diff.numel()
        bar = CODE_DIFF_MAX[c]
        sat = (f"; {int(((sk[c] == 127) | (sk[c] <= -127)).sum())} of {sk[c].numel()} at a "
               f"clip bound" if mode == "mxu" else "")
        print(f"  {name} {tag} {c}: the conversion of its own rows; "
              f"{diff.ne(0).float().mean().item():.3e} differ from the twin's, max |diff| "
              f"{diff.max().item()} (bar {bar}){sat}")
        check(diff.max().item() <= bar, f"{name}: {c} codes off the twin's by {diff.max().item()}")
    check(n_diff <= CODE_SHARE_MAX * n_codes, f"{name}: {n_diff} of {n_codes} codes drift")
    own_out = attr_own(fbq, block, mode, x, args, sk).to(x.dtype)
    err = (got.float() - ref.float()).abs().max().item()
    tol = ulp_bf16(ref.float().abs().max().item())
    print(f"kernel {name} {tag}: max_abs_err {err} (tolerance {tol} = 1 bf16 ulp of max |twin|); "
          f"{n_diff} codes off the twin's; output "
          f"{'bit-equal' if torch.equal(got, own_out) else 'NOT equal'} to the twin's last step "
          f"on its own codes")
    check(torch.equal(got, own_out), f"{name}: the output is not the twin's last step on its "
          f"own codes")
    check(math.isfinite(err) and (err <= tol or n_diff > 0),
          f"{name}: past 1 bf16 ulp of its twin with the twin's codes")
    return err


def sass_check_attr(lib, path) -> None:
    """The attribution's instantiations in the int8 library: the s8 GEMMs of
    its "mxu" blocks (gemm_s8_kernel at EQ_BIAS 0, EQ_BIAS_RESID 1,
    EQ_RESID_BIAS 4 and its own EQ_BIAS_S8 11) each hold IGMMA and UTMALDG,
    each softmax-off wgmma core (attention_wgmma_kernel<NK, packed, 0>, one
    per key bucket) HGMMA, and none of them mma.sync (HMMA., IMMA.); the stubs
    (cast_s8_kernel, bcast_rows_kernel, attention_vpu_core_kernel) are
    present.  A missing instantiation fails the run."""
    funcs = sass_functions(path)
    if funcs is None:
        print(f"sass attribution {lib}: no cuobjdump found: the per-kernel forms are not checked")
        return
    want = {**{f"gemm_s8_kernel<{e}>": (rf"gemm_s8_kernelILi{e}E", ("IGMMA", "UTMALDG"))
               for e in (0, 1, 4, 11)},
            "attention_wgmma_kernel<*, packed, softmax off>": (
                r"attention_wgmma_kernelILi\d+ELi0ELi0E", ("HGMMA",)),
            "cast_s8_kernel": (r"cast_s8_kernel", ()), "bcast_rows_kernel": (r"bcast_rows_kernel", ()),
            "attention_vpu_core_kernel": (r"attention_vpu_core_kernel", ())}
    for tag, (rx, ops) in want.items():
        bodies = [body for name, body in funcs.items() if re.search(rx, name)]
        check(bodies, f"sass {lib}: no {tag} in the library")
        for body in bodies:
            counts = {op: len(re.findall(SASS_OPS[op], body)) for op in ops + ("HMMA", "IMMA")}
            missing = [op for op in ops if counts[op] == 0]
            check(not missing, f"{tag} has no {missing} instructions in its SASS")
            check(counts["HMMA"] + counts["IMMA"] == 0, f"{tag} runs mma.sync ({counts})")
        print(f"sass {lib} attribution {tag}: {len(bodies)} instantiation(s), each with "
              f"{list(ops) or 'no MMA'} and no HMMA. / IMMA.")


def attr_checks(fbq, device, card):
    """The four attribution kernels against their twins at B=8 (x and x/16)
    and B=256 (``attr_compare``), then timed at B=256 beside K3 / K4 with
    their bounds.  Returns the kernels-line rows (launches set by the
    caller)."""
    import torch

    d, heads, s, f = KB_D, KB_H, KB_S, KB_F
    (qa, qakw), (qm, qmkw) = q_block_params(d, device, seed=26)
    params = {"mlp": (qm, qmkw), "attn": (qa, qakw)}
    g = torch.Generator().manual_seed(25)
    cases = [(KB_CHECK_B, 1.0), (KB_CHECK_B, 1 / 16), (BATCH, 0.5)]
    errs = {}
    for b, scale in cases:
        x = (torch.randn(b, s, d, generator=g) * scale).to(device, torch.bfloat16)
        tag = f"B={b} S={s} D={d} x~N(0,{scale}^2)"
        for block in ("mlp", "attn"):
            for mode in ("mxu", "vpu"):
                errs[(block, mode)] = attr_compare(fbq, block, mode, x, params[block], heads, tag)
    # the "mxu" attention past the register core's 320 keys: the long
    # route with its first pass skipped
    xl = torch.randn(2, 400, d, generator=g).to(device, torch.bfloat16)
    reset_all(fbq)
    attr_compare(fbq, "attn", "mxu", xl, params["attn"], heads, "B=2 S=400 (the long core)")
    check(fbq.CORE_ROUTES == {"short": 0, "long": 1},
          f"phase 25: the S=400 core took the routes {fbq.CORE_ROUTES}, expected one long")

    rows = {}
    base = {"attn": cuda_ms(lambda: fbq.attention_block_q(x, *qa, heads=heads, **qakw)),
            "mlp": cuda_ms(lambda: fbq.mlp_block_q(x, *qm, **qmkw))}
    for block in ("mlp", "attn"):
        args, qkw = params[block]
        entry = f"{ATTR_ENTRIES[block]}_attr"
        kern, plain = getattr(fbq, entry), getattr(fbq, f"{entry}_plain")
        for mode in ("mxu", "vpu"):
            kw = {"mode": mode, **({"heads": heads} if block == "attn" else {})}
            name = f"{entry}_{mode}"
            bound_ms, bound_by = bound(*attr_work(block, mode, BATCH, s, d, f, heads))
            rows[name] = {"name": name, "case": f"KB (c) ViT-B/16 B={BATCH} S={s} D={d} H={heads}",
                          "route": "cuda",
                          "source": "debias_vision_lang_torch/csrc/fused_block_q.cu",
                          "replaces": ATTR_REPLACES[name], "launches": None,
                          "max_abs_err": errs[(block, mode)],
                          "ms": cuda_ms(lambda: kern(x, *args, **kw, **qkw)),
                          "plain_ms": cuda_ms(lambda: plain(x, *args, **kw), iters=3),
                          "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
            r, k = rows[name], base[block]
            print(f"time {name} B={BATCH} S={s} D={d}: kernel {r['ms']:.4f} ms "
                  f"({'K4' if block == 'mlp' else 'K3'} beside it {k:.4f} ms, {r['ms'] / k:.3f}x), "
                  f"plain twin {r['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; the "
                  f"kernel at {bound_ms / r['ms']:.1%} of it) ({card})")
            subkernel_split(f"{name} B={BATCH}", lambda: kern(x, *args, **kw, **qkw),
                            attr_gemm_ops(block, BATCH * s, d, f), card, kind="int8",
                            rename={**ATTR_SPLIT_NAMES, **({"quantize x": QUANT_X_ATTN}
                                                          if kw.get("heads") else {})})
    del x, xl
    torch.cuda.empty_cache()
    return rows


def attr_towers(fbq, blocks, x0, card, iters=3):
    """The script's six 12-layer towers on ``blocks`` at x0's batch: the
    launches of each run counted (12 per tower: K3 / K4's counters for
    "full", KB_LAUNCHES for the other two), its output finite, its ms
    (``iters`` calls, CUDA events), and per block full / (mxu + vpu) and
    full / max(mxu, vpu).  Returns {kind: launches}."""
    import torch

    towers = {kind: kb_int8_tower(fbq, blocks, kind, kinds=ATTR_KINDS) for kind in ATTR_KINDS}
    launches, ms = {}, {}
    with torch.no_grad():
        for kind, run in towers.items():
            reset_all(fbq)
            out = run(x0)
            torch.cuda.synchronize()
            launches[kind] = nonzero({**fbq.LAUNCHES, **fbq.KB_LAUNCHES})
            want = {ATTR_COUNTERS[kind]: LAYERS}
            check(launches[kind] == want,
                  f"phase 25: {kind} tower launches {launches[kind]}, expected {want}")
            check(bool(torch.isfinite(out.float()).all()), f"phase 25: {kind} tower not finite")
            ms[kind] = cuda_ms(lambda: run(x0), iters=iters)
    b = x0.shape[0]
    for blk in ("mlp", "attn"):
        full, mxu, vpu = (ms[f"{blk}_{m}"] for m in ("full", "mxu", "vpu"))
        print(f"phase 25 {blk} towers, {LAYERS} layers at B={b}: full {full:.4f} ms, mxu "
              f"{mxu:.4f} ms, vpu {vpu:.4f} ms; full / (mxu + vpu) {full / (mxu + vpu):.4f}, "
              f"full / max(mxu, vpu) {full / max(mxu, vpu):.4f} ({card})")
    print(f"phase 25 tower launches: {launches}")
    return launches


def attr_phase(model, card, device):
    """Phase 25: benchmarks/q_attribution.py's blocks -- the SASS of their
    instantiations (``sass_check_attr``), each "mxu" / "vpu" kernel against
    its twin and timed (``attr_checks``), then the script's six 12-layer
    towers on the phase-4 model's resblocks quantized by
    ``quantize_resblocks`` at its B=512 on its inputs (``attr_towers``).
    Returns (kernels-line rows, wall)."""
    import torch
    from debias_vision_lang_torch.ops import _build
    from debias_vision_lang_torch.ops import fused_block_q as fbq
    from debias_vision_lang_torch.ops.quant import quantize_resblocks

    t_phase = time.perf_counter()
    sass_check_attr("fused_block_q", _build.LIB_PATHS["fused_block_q"])
    rows = attr_checks(fbq, device, card)
    walls = {"kernels": time.perf_counter() - t_phase}
    t = time.perf_counter()
    blocks = quantize_resblocks(model.clip.visual.resblocks)
    x0 = kb_inputs(ATTR_B, n=1)[0]
    launches = attr_towers(fbq, blocks, x0, card)
    for kind, name in ATTR_COUNTERS.items():
        if name in rows:
            rows[name]["launches"] = launches[kind][name]
    walls["towers"] = time.perf_counter() - t
    del blocks, x0
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"phase 25 walls: " + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
          + f"; total {wall:.2f} s ({card})")
    return [rows[k] for k in ATTR_REPLACES], wall


# phase 26: the root bench.py's configurations through the port's bench
# (benchmarks_torch/bench.py), each with the counters its kernels bump:
# (label, env, {counter: launches per call}); float32 at fewer steps
BENCH_CONFIGS = (
    ("a int8, P8 stem", {}, {"attention_block_q": 12, "mlp_block_q": 12}),
    ("b int8, f32 stem", {"BENCH_STEM": "f32"}, {"attention_block_q": 12, "mlp_block_q": 12}),
    ("c bf16, P8 stem", {"BENCH_QUANT": "0", "BENCH_STEM": "p8"},
     {"attention_block": 12, "mlp_block": 12}),
    ("d bf16, P8 stem, BENCH_PALLAS", {"BENCH_QUANT": "0", "BENCH_STEM": "p8",
                                       "BENCH_PALLAS": "1"}, {"attention_pallas": 12}),
    ("e bf16, f32 stem", {"BENCH_QUANT": "0"}, {"attention_block": 12, "mlp_block": 12}),
    ("f float32", {"BENCH_DTYPE": "float32", "BENCH_STEPS": "3"}, {}),
    ("f float32, BENCH_PALLAS", {"BENCH_DTYPE": "float32", "BENCH_PALLAS": "1",
                                 "BENCH_STEPS": "3"}, {"attention_pallas": 12}),
)
BENCH_HEADLINE_BATCHES = (256, 512, 1024)
BENCH_ROWS = 64  # the uint8 images every configuration embeds for the cosine bar
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}


def bench_record_check(tag, rec):
    check(set(rec) == BENCH_KEYS, f"{tag}: record keys {sorted(rec)}")
    check(rec["metric"] == "clip_vit_b16_embed_throughput" and rec["unit"] == "images/sec/chip",
          f"{tag}: record {rec}")
    check(rec["value"] > 0 and abs(rec["vs_baseline"] - rec["value"] / 1000) <= 5.5e-4,
          f"{tag}: record {rec}")


def bench_phase(card, device):
    """Phase 26: the port's bench (``benchmarks_torch/bench.py``) on its own
    ViT-B/16 (``init_clip_params`` at seed 0): each configuration a-f of the
    root bench.py through ``bench.run``, its record's contract, its launches
    (12 x (2 + steps) per kernel it runs, none of another; K5 on its short
    route only) and its rows on one uint8 buffer against float32's (cosine
    >= COS_MIN); config a at B = 256, 512, 1024; then ``python -m
    debias_vision_lang_torch bench`` in a subprocess (exit 0, one stdout
    line).  Returns the wall."""
    import importlib

    import torch
    from debias_vision_lang_torch.ops import attention as A
    from debias_vision_lang_torch.ops import fused_block as fb
    from debias_vision_lang_torch.ops import fused_block_q as fbq
    from debias_vision_lang_torch.core.registry import resolve_arch
    from debias_vision_lang_torch.vision.preprocess import patchify_u8

    B = importlib.import_module("benchmarks_torch.bench")
    t_phase = time.perf_counter()
    cfg = resolve_arch(B.ARCH)
    model = B.build_model(cfg, device)
    canvas = np.random.default_rng(26).integers(0, 256, (BENCH_ROWS, 224, 224, 3),
                                                dtype=np.uint8)
    staged = {False: torch.from_numpy(canvas).to(device),
              True: torch.from_numpy(patchify_u8(canvas, cfg.vision.patch_size)).to(device)}
    counters = (fb, fbq, A)
    rows, img_s = {}, {}
    for label, env, per_call in BENCH_CONFIGS:
        knobs = B.parse_knobs(env, on_card=True)
        embed, shape = B.make_embed(model, cfg, knobs, device)
        torch.cuda.synchronize()
        reset_all(*counters)
        rec = B.run(embed, shape, knobs, device)
        counts = launches_of(*counters)
        calls = 2 + knobs.steps
        want = {k: 0 for k in counts}
        want.update({k: n * calls for k, n in per_call.items()})
        print(f"bench {label}: {rec['value']} img/s at B={knobs.batch}, {knobs.steps} steps "
              f"(host clock), vs_baseline {rec['vs_baseline']}; launches {nonzero(counts)} "
              f"({card})")
        bench_record_check(f"bench {label}", rec)
        check(counts == want, f"bench {label}: launches {nonzero(counts)}, expected "
                              f"{nonzero(want)}")
        rows[label] = embed(staged[knobs.use_p8])
        img_s[label] = rec["value"]
        del embed
    ref = rows["f float32"]
    check(rows["f float32"].shape == (BENCH_ROWS, cfg.vision.embed_dim), "bench rows' shape")
    for label, got in rows.items():
        if label != "f float32":
            cosine_check(f"bench {label} vs f float32, {BENCH_ROWS} rows", got, ref)
    for batch in BENCH_HEADLINE_BATCHES:
        knobs = B.parse_knobs({"BENCH_BATCH": str(batch)}, on_card=True)
        embed, shape = B.make_embed(model, cfg, knobs, device)
        rec = B.run(embed, shape, knobs, device)
        bench_record_check(f"bench headline B={batch}", rec)
        print(f"bench headline (a) B={batch}: {rec['value']} img/s, vs_baseline "
              f"{rec['vs_baseline']} (host clock, {knobs.steps} steps; {card})")
        del embed
    del model, rows, staged
    torch.cuda.empty_cache()
    t = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    proc = subprocess.run([sys.executable, "-m", "debias_vision_lang_torch", "bench"],
                          cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                          capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    print(f"bench CLI: exit {proc.returncode} in {time.perf_counter() - t:.1f} s, stdout "
          f"{lines}; stderr tail {proc.stderr.strip().splitlines()[-1:]} ({card})")
    check(proc.returncode == 0, f"bench CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    check(len(lines) == 1, f"bench CLI printed {len(lines)} stdout lines")
    bench_record_check("bench CLI", json.loads(lines[0]))
    wall = time.perf_counter() - t_phase
    print(f"phase 26: {wall:.1f} s ({card})")
    return wall


# ---------------------------------------------------------------------------
# phase 27: K1-K4 at the shapes their JAX kernels take and the port's CUDA
# entries refused before (head dims other than 64, widths off the GEMM
# tiles, hidden rows past 4,096, any F-split), on the padded operand
# layouts of ops/fused_block.py::attn_plan / mlp_plan
# ---------------------------------------------------------------------------

# (label, D, heads, F, activation, ((B, S, causal), ...)[, the kernels run,
# else all four]): public models' widths, used as shapes only (no registry
# arch)
SHAPE_CASES = (
    ("SigLIP-So400m widths", 1152, 16, 4304, "gelu", ((64, 257, False), (8, 729, False))),
    ("ViT-H/14 widths", 1280, 16, 5120, "gelu", ((64, 257, False),)),
    ("ViT-bigG/14 widths", 1664, 16, 8192, "gelu", ((32, 257, False),)),
    ("D=200 H=2", 200, 2, 808, "quick_gelu", ((8, 77, False), (8, 77, True))),
    # one head of 256 and one of 800: the long core's wide-head mode at any
    # S (output groups of at most four 64-dim chunks).  At hd 800 K3's attention codes drift past phase 6's share
    # bar (3.0e-3 unmasked, 3.5e-3 causal at S=77; its rows within 1 ulp of
    # the twin's core, its output exact on its own codes: PERF.md section
    # 7), so K3's wide-head path is held at hd 256 and hd 800 runs K1, K2
    # and K4
    ("D=256 H=1", 256, 1, 1024, "quick_gelu", ((8, 77, False),)),
    ("D=800 H=1", 800, 1, 3200, "quick_gelu", ((4, 77, False),),
     ("attention_block", "mlp_block", "mlp_block_q")),
)
SHAPE_FSPLIT = ("SigLIP-So400m widths", 1152, 4304, 4, 64, 257)  # K4 at fb = F / 4
# one tower at ViT-H/14's widths (OpenCLIP's ViT-H-14.json: 32 layers, D =
# 1280, 16 heads of 80, patch 14, 224 px, F = 5120, erf gelu in its MLP;
# the text tower cut to one narrow layer, which this phase does not run)
SHAPE_TOWER = {"width": 1280, "layers": 32, "heads": 16, "patch": 14, "px": 224,
               "embed": 1024, "b": 32}


def wide_core_split(row, case, call, b, s, d, hd, causal, device, card):
    """K1's core alone at one wide head (the long route's wide-head mode on
    the packed source): its device time from the block's sub-kernel split,
    its bound (Q K^T and P V at the true head dim against qkv read and attn
    written once) and one scaled_dot_product_attention call on [B, 1, S, hd]
    bf16 q, k, v (the same function), added to the block's row as
    core_ms, core_bound_ms and core_library_ms."""
    import torch
    from debias_vision_lang_torch.ops import attention as A

    parts = subkernel_split(f"attention_block {case}", call,
                            {"QKV GEMM": 2 * b * s * d * 3 * d, "out GEMM": 2 * b * s * d * d},
                            card)
    g = torch.Generator().manual_seed(hd)
    q, k, v = (torch.randn(b, 1, s, hd, generator=g).to(device, torch.bfloat16)
               for _ in range(3))
    row["core_ms"] = parts.get("core")
    row["core_bound_ms"], by = bound({"bf16": 4 * b * s * s * hd}, 4 * b * s * hd * 2)
    row["core_library_ms"] = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal), 5)
    # late in a long process the profiler can record no device event (an
    # empty split): the core's time is then not measured, never guessed
    core = row["core_ms"]
    print(f"time attention_block core {case} (wide-head mode, "
          f"{len(A._wide_groups(A._padded_head_dim(hd)))} output group(s)): "
          + (f"{core:.4f} ms (torch.profiler), the core at {row['core_bound_ms'] / core:.1%} of "
             f"its bound" if core else "not measured (the profiler recorded no core)")
          + f"; SDPA {row['core_library_ms']:.4f} ms, bound {row['core_bound_ms']:.4f} ms ({by})"
          f" ({card})")


def shape_params(d, f, device, seed):
    """block_params at hidden width f: (bf16 attention and MLP tensors,
    their int8 blocks with the kernels' transposed copies)."""
    import torch
    from debias_vision_lang_torch.ops.quant import QWeight

    g = torch.Generator().manual_seed(seed)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(device)

    attn = (1 + 0.1 * rn(d), 0.1 * rn(d), rn(d, 3 * d, std=d ** -0.5),
            0.1 * rn(3 * d), rn(d, d, std=d ** -0.5), 0.1 * rn(d))
    mlp = (1 + 0.1 * rn(d), 0.1 * rn(d), rn(d, f, std=(2 * d) ** -0.5), 0.1 * rn(f),
           rn(f, d, std=f ** -0.5), 0.1 * rn(d))
    (ls, lb, wqkv, bqkv, wo, bo), (l2s, l2b, w1, b1, w2, b2) = attn, mlp
    qkv, qo, q1, q2 = map(QWeight, (wqkv, wo, w1, w2))
    qattn = ((ls, lb, qkv.q, qkv.scale, bqkv, qo.q, qo.scale, bo),
             {"wqkv_qt": qkv.qt, "wo_qt": qo.qt})
    qmlp = ((l2s, l2b, q1.q, q1.scale, b1, q2.q, q2.scale, b2), {"w1_qt": q1.qt, "w2_qt": q2.qt})
    return attn, mlp, qattn, qmlp


def shape_checks(fb, fbq, device, card):
    """Phase 27's kernel checks: K1-K4 at every SHAPE_CASES shape against
    their twins (x and x/16; the int8 codes under phase 6's bars), each
    launch counted and its core route named, then timed against the bound
    of the true (unpadded) work; K4's F-split at fb = F / 4.  Returns the
    kernels-line rows (launches: the checks' own)."""
    import torch

    rows = []
    counters = {"fused_block": fb.LAUNCHES, "fused_block_q": fbq.LAUNCHES}
    for label, d, heads, f, act, cases, *only in SHAPE_CASES:
        attn, mlp, qattn, qmlp = shape_params(d, f, device, seed=d)
        plan, mplan = fb.attn_plan(d, heads), fb.mlp_plan(d, f)
        hd = d // heads
        print(f"phase 27 {label}: D={d} heads={heads} hd={hd} F={f} {act}: layout hdp "
              f"{plan.hdp}, qkv row {plan.nqkv} (of {3 * d}), LN row {plan.dk}, out N "
              f"{plan.no}, hidden {mplan.fp} (identity: attention {plan.identity}, MLP "
              f"{mplan.identity})")
        for b, s, causal in cases:
            route = fb.core_route(s, hd)
            case = f"{label} B={b} S={s} D={d} H={heads} hd={hd} F={f}" + (
                " causal" if causal else "")
            akw, mkw = {"heads": heads, "causal": causal}, {"act_kind": act}
            kernels = [("attention_block", "fused_block", 69, fb.attention_block,
                        fb.attention_block_plain, attn, {}, akw,
                        attention_block_work(b, s, d, causal=causal)),
                       ("attention_block_q", "fused_block_q", 62, fbq.attention_block_q,
                        fbq.attention_block_q_plain, qattn[0], qattn[1], akw,
                        attention_block_work(b, s, d, causal=causal, weights="int8"))]
            if not causal:
                kernels += [("mlp_block", "fused_block", 192, fb.mlp_block,
                             fb.mlp_block_plain, mlp, {}, mkw, mlp_block_work(b, s, d, f)),
                            ("mlp_block_q", "fused_block_q", 106, fbq.mlp_block_q,
                             fbq.mlp_block_q_plain, qmlp[0], qmlp[1], mkw,
                             mlp_block_work(b, s, d, f, weights="int8"))]
            if only:
                kernels = [k for k in kernels if k[0] in only[0]]
            g = torch.Generator().manual_seed(27 + s)
            x0 = torch.randn(b, s, d, generator=g).to(device, torch.bfloat16)
            for name, lib, line, kern, plain, args, qkw, kw, work in kernels:
                key = name + ("_causal" if causal and name.startswith("attention") else "")
                errs, launches = [], 0
                for scale in (1.0, 1 / 16):
                    x = (x0.float() * scale).to(torch.bfloat16)
                    tag = f"{name} {case} x~N(0,{scale}^2) (phase 27)"
                    fb.reset_launches()
                    fbq.reset_launches()
                    if lib == "fused_block":
                        errs.append(compare_bf16(tag, x, kern(x, *args, **kw),
                                                 plain(x, *args, **kw)))
                    else:
                        errs.append(compare_q(fbq, tag, kern, plain, x, (args, qkw), kw,
                                              long_core=name.startswith("attention")
                                              and route == "long"))
                    torch.cuda.synchronize()
                    got = {k: v for k, v in counters[lib].items() if v}
                    routes = {k: v for k, v in (fb.CORE_ROUTES if lib == "fused_block"
                                                else fbq.CORE_ROUTES).items() if v}
                    want_routes = {route: 1} if name.startswith("attention") else {}
                    check(got == {key: 1} and routes == want_routes,
                          f"{tag}: launches {got}, core routes {routes}; expected {{{key!r}: "
                          f"1}}, {want_routes}")
                    launches += 1
                print(f"phase 27 {name} {case}: launches {launches} ({key}), core route "
                      f"{route if name.startswith('attention') else '-'}")
                row = kernel_row(name, case, lib, line, max(errs),
                                 cuda_ms(lambda: kern(x0, *args, **kw, **qkw), iters=5),
                                 cuda_ms(lambda: plain(x0, *args, **kw), iters=2), work)
                row["launches"] = launches
                rows.append(row)
                print(f"time {name} {case}: kernel {row['ms']:.4f} ms, plain twin "
                      f"{row['plain_ms']:.4f} ms, bound of the true work {row['bound_ms']:.4f} "
                      f"ms ({row['bound_by']}; the kernel at {row['bound_ms'] / row['ms']:.1%} "
                      f"of it) ({card})")
                if name == "attention_block" and heads == 1 and hd > 128:
                    wide_core_split(row, case, lambda: kern(x0, *args, **kw), b, s, d, hd,
                                    causal, device, card)
            del x0
        del attn, mlp, qattn, qmlp
        torch.cuda.empty_cache()
    # K4's F-split at fb = F / 4: each chunk of 1,076 hidden columns padded to 1,152
    label, d, f, k, b, s = SHAPE_FSPLIT
    _, _, _, qmlp = shape_params(d, f, device, seed=f)
    fbv = f // k
    case = f"{label} B={b} S={s} D={d} F={f} fb={fbv}"
    g = torch.Generator().manual_seed(2704)
    x0 = torch.randn(b, s, d, generator=g).to(device, torch.bfloat16)
    errs = []
    for scale in (1.0, 1 / 16):
        x = (x0.float() * scale).to(torch.bfloat16)
        fbq.reset_launches()
        errs.append(compare_q(fbq, f"mlp_block_q {case} x~N(0,{scale}^2) (phase 27)",
                              fbq.mlp_block_q, fbq.mlp_block_q_plain, x, qmlp, {"fb": fbv}))
        torch.cuda.synchronize()
        check(fbq.KB_LAUNCHES["mlp_block_q_fsplit"] == 1 and sum(fbq.LAUNCHES.values()) == 0,
              f"mlp_block_q fb={fbv}: launches {fbq.KB_LAUNCHES}, {fbq.LAUNCHES}")
    row = kernel_row("mlp_block_q_fsplit", case, "fused_block_q", 106, max(errs),
                     cuda_ms(lambda: fbq.mlp_block_q(x0, *qmlp[0], fb=fbv, **qmlp[1]), iters=5),
                     cuda_ms(lambda: fbq.mlp_block_q_plain(x0, *qmlp[0], fb=fbv), iters=2),
                     mlp_block_work(b, s, d, f, weights="int8"))
    row["launches"] = 2
    rows.append(row)
    print(f"time mlp_block_q_fsplit {case}: kernel {row['ms']:.4f} ms, plain twin "
          f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}; the "
          f"kernel at {row['bound_ms'] / row['ms']:.1%} of it) ({card})")
    del x0, qmlp
    torch.cuda.empty_cache()
    mlp_q_hold(fbq, device, 27, shapes=True)
    padding_cost(fb, fbq, device, card)
    return rows


def padding_cost(fb, fbq, device, card):
    """What the head-dim padding costs: K1 and K3 at ViT-H/14's width (B=64
    S=257 D=1280) with 16 heads of 80 (padded to 128: the QKV product 1.6x,
    the core 2x the true work) against 20 heads of 64 (no padding, the same
    D and the same true GEMM work), timed in turns in one process."""
    import torch

    b, s, d = 64, 257, 1280
    attn, _, qattn, _ = shape_params(d, 4 * d, device, seed=2705)
    x = torch.randn(b, s, d, generator=torch.Generator().manual_seed(2705)).to(
        device, torch.bfloat16)
    for name, kern, args, qkw in (("attention_block", fb.attention_block, attn, {}),
                                  ("attention_block_q", fbq.attention_block_q, qattn[0],
                                   qattn[1])):
        ms = {}
        for heads in (16, 20, 20, 16):
            t = cuda_ms(lambda: kern(x, *args, heads=heads, **qkw), iters=10)
            ms.setdefault(heads, []).append(t)
        hd16, hd20 = sum(ms[16]) / 2, sum(ms[20]) / 2
        print(f"padding cost {name} B={b} S={s} D={d}: 16 heads of 80 (hdp 128) {hd16:.4f} ms "
              f"{[round(t, 4) for t in ms[16]]}, 20 heads of 64 {hd20:.4f} ms "
              f"{[round(t, 4) for t in ms[20]]}: {hd16 / hd20:.3f}x ({card})")
    del x, attn, qattn
    torch.cuda.empty_cache()


# K5 on the long route past head dim 192 (the wide-head mode) and at 192
# (the head resident): (B, H, head dim, S), float32 and bfloat16, a random
# additive mask; B=8 H=12 is a Frozen-in-Time joint tower's batch and heads
WIDE_K5 = ((2, 4, 256, 77), (2, 4, 256, 785), (2, 4, 800, 77), (2, 4, 800, 785),
           (8, 12, 256, 785), (8, 12, 800, 785), (8, 12, 192, 785))
# (B, H, head dim, S, dtype): the first 16 hex digits of the sha256 of the
# output of the wide-head design this mode replaced (one 64-dim output
# chunk a block, its scores recomputed per chunk; hd 192 the resident
# blocks, unchanged) on wide_k5_inputs, NVIDIA H100 80GB HBM3: the mode
# keeps the order of every sum, so phase 27 expects the same bits
WIDE_K5_PARENT = {
    (2, 4, 256, 77, "float32"): "cdae7d5d451401c7",
    (2, 4, 256, 785, "float32"): "50b9b9672ad1047d",
    (2, 4, 800, 77, "float32"): "bc4b5845c66d71c2",
    (2, 4, 800, 785, "float32"): "de9f8c025a05e3f0",
    (8, 12, 256, 785, "float32"): "57e5515c19bea457",
    (8, 12, 800, 785, "float32"): "133ffd0f8ad1ee22",
    (8, 12, 192, 785, "float32"): "55ee0406c3618e8d",
    (2, 4, 256, 77, "bfloat16"): "4fc0c6e50de20220",
    (2, 4, 256, 785, "bfloat16"): "5cc43078341a783d",
    (2, 4, 800, 77, "bfloat16"): "1324f895a566adce",
    (2, 4, 800, 785, "bfloat16"): "1e3027b938a4a7e6",
    (8, 12, 256, 785, "bfloat16"): "eca583ed6ce6e715",
    (8, 12, 800, 785, "bfloat16"): "1704f993c1337bfe",
    (8, 12, 192, 785, "bfloat16"): "dc7f6b6570e877f4",
}
# KB (a) 1 off its register route: (B, S, D, H), past 256 keys at ViT-B/16's
# width and head dim 80 (D = 960, 12 heads), B=2; and at the int8 joint
# Frozen-in-Time tower's attention, B=32 S=785, timed beside K3 (its long core)
WIDE_QQ = ((2, 257, 768, 12), (2, 785, 768, 12), (2, 197, 960, 12), (32, 785, 768, 12))
# the KB entries off the registry widths: D = 200, 2 heads of 100, F = 800
KB_OFF = {"d": 200, "heads": 2, "f": 800, "b": 8, "s": 77}


def wide_k5_inputs(b, h, hd, s, dtype, device):
    """Phase 27's K5 q, k, v and mask for one case, from the case's own seed
    (CPU generator, so every card sees the same inputs)."""
    import torch

    g = torch.Generator().manual_seed(int(f"{b}{h:02d}{hd:04d}{s:04d}{dtype.itemsize}"))
    q, k, v = (torch.randn(b, h, s, hd, generator=g).to(device, dtype) for _ in range(3))
    return q, k, v, torch.randn(s, s, generator=g).to(device)


def tensor_digest(t) -> str:
    """The first 16 hex digits of the sha256 of a tensor's bytes."""
    import hashlib

    import torch

    raw = t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def k5_row(A, tag, q, k, v, mask, err, launches, f32):
    """A kernels-line row of K5 at a phase-27 shape (timed, beside SDPA)."""
    import torch

    b, h, s, hd = q.shape
    work = bound(*attention_work(b, h, s, f32, hd=hd))
    lib_mask = mask.to(q.dtype)
    return {"name": "attention_pallas_long", "case": tag, "route": "cuda",
            "source": "debias_vision_lang_torch/csrc/attention.cu",
            "replaces": "debias_vision_lang_tpu/ops/attention.py:93", "launches": launches,
            "max_abs_err": err, "ms": cuda_ms(lambda: A.attention_pallas(q, k, v, mask), 5),
            "plain_ms": cuda_ms(lambda: A.attention_kernel_math(q, k, v, mask), 2),
            "bound_ms": work[0], "bound_by": work[1],
            "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=lib_mask), 5)}


def wide_checks(fb, fbq, device, card):
    """Phase 27's checks of the shapes the card once refused past K1-K4: K5
    at head dims 256 and 800 (S = 77 and 785, float32 and bfloat16, phase
    9's bars, one long-route launch each), KB (a) 1's int8 core and block
    past 256 keys and at head dim 80 (its tiled route; qq_core_check's and
    kb_compare's bars), and every KB entry at D = 200 with 2 heads of 100
    (their phases' comparisons and bars, one launch each).  Returns the
    kernels-line rows (launches: the checks' own)."""
    import torch
    from debias_vision_lang_torch.ops import attention as A

    rows = []
    g = torch.Generator().manual_seed(2722)
    for f32 in (True, False):
        dt = torch.float32 if f32 else torch.bfloat16
        for b, h, hd, s in WIDE_K5:
            q, k, v, mask = wide_k5_inputs(b, h, hd, s, dt, device)
            A.reset_launches()
            got = A.attention_pallas(q, k, v, mask)
            torch.cuda.synchronize()
            launched, wide = dict(A.LAUNCHES), dict(A.WIDE_LAUNCHES)
            ref = A.attention_kernel_math(q, k, v, mask)
            err = (got.float() - ref.float()).abs().max().item()
            mag = ref.float().abs().max().item()
            tol = 2e-5 * mag if f32 else ulp_bf16(mag)
            hdp = A._padded_head_dim(hd)
            groups = A._wide_groups(hdp) if hdp > A.RESIDENT_MAX_HDP else []
            want_wide = {"split_tf32": int(f32 and bool(groups)), "row_stats": int(len(groups) > 1)}
            tag = (f"attention_pallas {'f32' if f32 else 'bf16'} B={b} H={h} S={s} hd={hd} "
                   f"mask=random")
            mode = (f"wide-head mode, output groups of {[c1 - c0 for c0, c1 in groups]} "
                    f"64-dim chunks" if groups else "the head resident")
            print(f"kernel {tag} (long route, {mode}): max_abs_err {err} (tolerance {tol} = "
                  f"{'2e-5 x' if f32 else '1 bf16 ulp of'} max |twin| {mag}); launches {launched}"
                  f", beside the output launch {wide} (phase 27)")
            check(got.shape == q.shape and math.isfinite(err) and err <= tol,
                  f"{tag}: kernel disagrees with its twin")
            check(launched == {"attention_pallas": 0, "attention_pallas_long": 1}
                  and wide == want_wide, f"{tag}: launches {launched}, {wide}; expected "
                  f"one long-route call and {want_wide}")
            # the design this mode replaced, on the same inputs (WIDE_K5_PARENT)
            digest, parent = tensor_digest(got), WIDE_K5_PARENT.get((b, h, hd, s, str(dt)[6:]))
            same = ("no record" if parent is None else "bit-identical" if digest == parent
                    else f"differs (its digest {parent})")
            print(f"parent check {tag}: output digest {digest}; against the one-chunk-a-block "
                  f"design's output: {same} (phase 27)")
            if s == 785:
                rows.append(k5_row(A, tag, q, k, v, mask, err, 1, f32))
                r = rows[-1]
                print(f"time {tag}: kernel {r['ms']:.4f} ms, plain twin {r['plain_ms']:.4f} ms, "
                      f"SDPA {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                      f"({r['bound_by']}; the kernel at {r['bound_ms'] / r['ms']:.1%} of it) "
                      f"({card})")
            del q, k, v, mask, got, ref
        torch.cuda.empty_cache()
    # KB (a) 1: the core on random f32 qkv, then the block
    for b, s, d, heads in WIDE_QQ:
        qkv = torch.randn(b, s, 3 * d, generator=g).to(device)
        fbq.reset_launches()
        core_err = qq_core_check(fbq, qkv, heads)
        torch.cuda.synchronize()
        check(fbq.QQ_ROUTES == {"register": 0, "tiled": 1}
              and fbq.KB_LAUNCHES["attention_qq_core"] == 1,
              f"attention_qq_core S={s} D={d}: routes {fbq.QQ_ROUTES}, launches "
              f"{fbq.KB_LAUNCHES['attention_qq_core']}")
        (qa, qakw), _ = q_block_params(d, device, seed=s + d)
        x = torch.randn(b, s, d, generator=g).to(device, torch.bfloat16)
        name = f"attention_block_qq B={b} S={s} D={d} H={heads} hd={d // heads} (phase 27)"
        fbq.reset_launches()
        blk_err = kb_compare(fbq, name, fbq.attention_block_qq, fbq.attention_block_qq_plain, x,
                             (qa, qakw), {"heads": heads}, fbq.quant_rows, True, code_bars=False)
        torch.cuda.synchronize()
        check(fbq.KB_LAUNCHES["attention_block_qq"] == 1 and fbq.QQ_ROUTES["tiled"] == 1,
              f"{name}: launches {nonzero(fbq.KB_LAUNCHES)}, routes {fbq.QQ_ROUTES}")
        case = f"KB (a) 1 B={b} S={s} D={d} H={heads} hd={d // heads} (tiled route)"
        for kname, err, kern, plain, work in (
                ("attention_qq_core", core_err, lambda: fbq.attention_qq_core(qkv, heads),
                 lambda: fbq.attention_qq_core_plain(qkv, heads, torch.bfloat16),
                 qq_core_work(b, s, d, heads)),
                ("attention_block_qq", blk_err,
                 lambda: fbq.attention_block_qq(x, *qa, heads=heads, **qakw),
                 lambda: fbq.attention_block_qq_plain(x, *qa, heads=heads),
                 qq_work(b, s, d, heads))):
            bound_ms, bound_by = bound(*work)
            r = {"name": kname, "case": case, "route": "cuda",
                 "source": "debias_vision_lang_torch/csrc/" + (
                     "attention_qq.cuh" if kname == "attention_qq_core" else "fused_block_q.cu"),
                 "replaces": KB_REPLACES[kname], "launches": 1, "max_abs_err": err,
                 "ms": cuda_ms(kern, 5), "plain_ms": cuda_ms(plain, 2), "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": None}
            rows.append(r)
            print(f"time {kname} {case}: kernel {r['ms']:.4f} ms, plain twin "
                  f"{r['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; the kernel at "
                  f"{bound_ms / r['ms']:.1%} of it) ({card})")
        if b > 2:  # K3 beside it (its core's share: benchmarks_torch/qq_core_times.py;
            # the profiler records little this late in the smoke)
            k3 = cuda_ms(lambda: fbq.attention_block_q(x, *qa, heads=heads, **qakw), 5)
            print(f"time attention_block_q (K3, its core on the long route) B={b} S={s} D={d} "
                  f"beside KB (a) 1: {k3:.4f} ms ({card})")
        del qkv, x, qa, qakw
    rows += kb_off_registry(fb, fbq, device, card)
    torch.cuda.empty_cache()
    return rows


def mlp_kb_check(fb, fbq, name, kern, plain, x, block, kw, quant, hidden):
    """An int8 KB MLP entry against its twin when its x codes may differ from
    the twin's (LayerNorm's f32 rounding flips one now and then, and a
    flipped x code moves its whole row of the hidden by a dequantized weight,
    so that row's hidden codes off the twin's by more than one): kb_compare's
    checks (x codes under phase 6's bars, every code the quantization of the
    kernel's own rows, the output within 1 bf16 ulp of the twin's last step
    on its own codes, and of the twin's output unless a code differs), and
    the hidden codes under phase 6's bars against the twin's hidden step on
    the kernel's own x codes (``hidden``: the entry's activation of the f32
    pre-activation, ``quant`` its quantizer).  Returns the largest output
    difference from the twin."""
    seen = {}

    def kern_seen(x_, *a, scratch, **k):
        seen["sk"] = scratch
        return kern(x_, *a, scratch=scratch, **k)

    err = kb_compare(fbq, name, kern_seen, plain, x, block, kw, quant, False, code_bars=False)
    sk, args = seen["sk"], block[0]
    q, _ = quant(hidden(fbq.dot_q(sk["xq"], sk["xs"], args[2], args[3]) + args[4].float()))
    diff = (sk["hq"].int() - q.int()).abs()
    share = diff.ne(0).float().mean().item()
    print(f"  {name} hq: {share:.3e} differ from the twin's hidden step on the kernel's own x "
          f"codes, max |diff| {diff.max().item()} (bars {CODE_DIFF_MAX['hq']}, {CODE_SHARE_MAX})")
    check(diff.max().item() <= CODE_DIFF_MAX["hq"] and share <= CODE_SHARE_MAX,
          f"{name}: hidden codes off the twin's on its own x codes")
    return err


def kb_off_registry(fb, fbq, device, card):
    """Every KB entry at D = 200, 2 heads of 100, F = 800 (KB_OFF; the
    padded layouts of attn_plan / mlp_plan), B=8 S=77, x and x/16: each
    against its twin by its own phase's comparison (kb_compare, compare_q,
    attr_compare, layer_compare, compare_bf16 / compare_part), one launch of
    its counter per call.  Returns the kernels-line rows, each timed once."""
    import torch

    o = KB_OFF
    d, heads, f, b, s = o["d"], o["heads"], o["f"], o["b"], o["s"]
    attn, mlp, qattn, qmlp = shape_params(d, f, device, seed=2723)
    (qa, qakw), (qm, qmkw) = qattn, qmlp
    ls, lb, wqkv, bqkv, wo, bo = attn
    wq_s, bq_s = fb.prescale_qkv(wqkv, bqkv, d, heads)
    kb6 = hgrid_operands(attn, heads)
    recip, div = fbq.quant_rows_recip, fbq.quant_rows
    plan, mplan = fb.attn_plan(d, heads), fb.mlp_plan(d, f)
    label = f"D={d} H={heads} hd={d // heads} F={f}"
    print(f"phase 27 KB entries at {label}: layout hdp {plan.hdp}, qkv row {plan.nqkv}, LN row "
          f"{plan.dk}, out N {plan.no}, hidden {mplan.fp}")
    # name: (counter (lib, key), the check on x, kernel, twin, work, replaces)
    akw = {"heads": heads}
    entries = {
        "attention_block_q_var": (
            ("q", "attention_block_q_var"),
            lambda x, t: compare_q(fbq, t, fbq.attention_block_q_var,
                                   fbq.attention_block_q_var_plain, x, qattn, akw, quant=recip),
            lambda x: fbq.attention_block_q_var(x, *qa, **akw, **qakw),
            lambda x: fbq.attention_block_q_var_plain(x, *qa, **akw),
            attention_block_work(b, s, d, weights="int8"), KB_REPLACES["attention_block_q_var"]),
        "attention_block_q_postdiv": (
            ("q", "attention_block_q_postdiv"),
            lambda x, t: compare_q(fbq, t, fbq.attention_block_q_postdiv,
                                   fbq.attention_block_q_postdiv_plain, x, qattn, akw),
            lambda x: fbq.attention_block_q_postdiv(x, *qa, **akw, **qakw),
            lambda x: fbq.attention_block_q_postdiv_plain(x, *qa, **akw),
            attention_block_work(b, s, d, weights="int8"),
            SPLIT_REPLACES["attention_block_q_postdiv"]),
        "attention_block_qq": (
            ("q", "attention_block_qq"),
            lambda x, t: kb_compare(fbq, t, fbq.attention_block_qq, fbq.attention_block_qq_plain,
                                    x, qattn, akw, div, True, code_bars=False),
            lambda x: fbq.attention_block_qq(x, *qa, **akw, **qakw),
            lambda x: fbq.attention_block_qq_plain(x, *qa, **akw),
            qq_work(b, s, d, heads), KB_REPLACES["attention_block_qq"]),
        "mlp_block_q_bf16h": (
            ("q", "mlp_block_q_bf16h"),
            lambda x, t: mlp_kb_check(fb, fbq, t, fbq.mlp_block_q_bf16h,
                                      fbq.mlp_block_q_bf16h_plain, x, qmlp, {}, div,
                                      lambda u: fb._act(u.to(torch.bfloat16).float(),
                                                        "quick_gelu")),
            lambda x: fbq.mlp_block_q_bf16h(x, *qm, **qmkw),
            lambda x: fbq.mlp_block_q_bf16h_plain(x, *qm),
            mlp_block_work(b, s, d, f, weights="int8"), KB_REPLACES["mlp_block_q_bf16h"]),
        "mlp_block_q_var": (
            ("q", "mlp_block_q_var"),
            lambda x, t: mlp_kb_check(fb, fbq, t, fbq.mlp_block_q_var, fbq.mlp_block_q_var_plain,
                                      x, qmlp, {}, recip, lambda u: fb._act(u, "quick_gelu")),
            lambda x: fbq.mlp_block_q_var(x, *qm, **qmkw),
            lambda x: fbq.mlp_block_q_var_plain(x, *qm),
            mlp_block_work(b, s, d, f, weights="int8"), KB_REPLACES["mlp_block_q_var"]),
        "mlp_block_q_var_bf16_gelu": (
            ("q", "mlp_block_q_var_bf16_gelu"),
            lambda x, t: mlp_kb_check(fb, fbq, t, fbq.mlp_block_q_var, fbq.mlp_block_q_var_plain,
                                      x, qmlp, {"bf16_gelu": True}, recip, fbq.quick_gelu_bf16),
            lambda x: fbq.mlp_block_q_var(x, *qm, bf16_gelu=True, **qmkw),
            lambda x: fbq.mlp_block_q_var_plain(x, *qm, bf16_gelu=True),
            mlp_block_work(b, s, d, f, weights="int8"),
            KB_REPLACES["mlp_block_q_var_bf16_gelu"]),
        "fused_layer_q": (
            ("q", "fused_layer_q"),
            lambda x, t: layer_compare(fbq, t, x, qa, qakw, qm, qmkw, heads),
            lambda x: fbq.fused_layer_q(x, *qa, *qm, heads=heads, **qakw, **qmkw),
            lambda x: fbq.fused_layer_q_plain(x, *qa, *qm, heads=heads),
            layer_work(b, s, d, f), SPLIT_REPLACES["fused_layer_q"]),
        "attention_block_opt": (
            ("bf16", "attention_block_opt"),
            lambda x, t: compare_bf16(t, x, fb.attention_block_opt(x, ls, lb, wq_s, bq_s, wo, bo,
                                                                   heads=heads),
                                      fb.attention_block_opt_plain(x, ls, lb, wq_s, bq_s, wo,
                                                                   bo, heads=heads)),
            lambda x: fb.attention_block_opt(x, ls, lb, wq_s, bq_s, wo, bo, heads=heads),
            lambda x: fb.attention_block_opt_plain(x, ls, lb, wq_s, bq_s, wo, bo, heads=heads),
            attention_block_work(b, s, d), SPLIT_REPLACES["attention_block_opt"]),
        "attention_block_hgrid": (
            ("tp", "attention_block_hgrid"),
            lambda x, t: compare_bf16(t, x, fb.attention_block_hgrid(x, *kb6, heads=heads),
                                      fb.attention_block_hgrid_plain(x, *kb6, heads=heads)),
            lambda x: fb.attention_block_hgrid(x, *kb6, heads=heads),
            lambda x: fb.attention_block_hgrid_plain(x, *kb6, heads=heads),
            attention_block_work(b, s, d), TP_REPLACES["attention_block_hgrid"]),
    }
    for blk in ("attn", "mlp"):
        for mode in ("mxu", "vpu"):
            entry = f"{ATTR_ENTRIES[blk]}_attr"
            params = qattn if blk == "attn" else qmlp
            kw = {"mode": mode, **(akw if blk == "attn" else {})}
            entries[f"{entry}_{mode}"] = (
                ("q", f"{entry}_{mode}"),
                functools.partial(lambda bl, md, pr, x, t: attr_compare(fbq, bl, md, x, pr, heads,
                                                                        t), blk, mode, params),
                functools.partial(lambda en, pr, kw_, x: getattr(fbq, en)(x, *pr[0], **kw_,
                                                                          **pr[1]),
                                  entry, params, kw),
                functools.partial(lambda en, pr, kw_, x: getattr(fbq, en + "_plain")(x, *pr[0],
                                                                                     **kw_),
                                  entry, params, kw),
                attr_work(blk, mode, b, s, d, f, heads), ATTR_REPLACES[f"{entry}_{mode}"])
    counters = {"q": fbq.KB_LAUNCHES, "bf16": fb.KB_LAUNCHES, "tp": fb.TP_LAUNCHES}
    g = torch.Generator().manual_seed(2724)
    x0 = torch.randn(b, s, d, generator=g).to(device, torch.bfloat16)
    rows = []
    for name, ((lib, key), compare, kern, plain, work, replaces) in entries.items():
        errs = []
        for scale in (1.0, 1 / 16):
            x = (x0.float() * scale).to(torch.bfloat16)
            fb.reset_launches()
            fbq.reset_launches()
            errs.append(compare(x, f"{name} B={b} S={s} {label} x~N(0,{scale}^2) (phase 27)"))
            torch.cuda.synchronize()
            check(counters[lib][key] == 1, f"phase 27 {name} {label}: launches "
                  f"{counters[lib][key]} on {key}")
        bound_ms, bound_by = bound(*work)
        r = {"name": name, "case": f"KB B={b} S={s} {label}", "route": "cuda",
             "source": "debias_vision_lang_torch/csrc/" + (
                 "fused_block_q.cu" if lib == "q" else "fused_block.cu"),
             "replaces": replaces, "launches": 2, "max_abs_err": max(errs),
             "ms": cuda_ms(lambda: kern(x0), 5), "plain_ms": cuda_ms(lambda: plain(x0), 2),
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        rows.append(r)
        print(f"time {name} {r['case']}: kernel {r['ms']:.4f} ms, plain twin "
              f"{r['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; the kernel at "
              f"{bound_ms / r['ms']:.1%} of it) ({card})")
    del x0
    return rows


def shape_tower(fb, fbq, card, device):
    """Phase 27's tower: a CLIP from a hand-built CLIPConfig at ViT-H/14's
    image widths (SHAPE_TOWER, random weights from seed 0), bf16 and int8 at
    B=32 on random normalized images: every block on K1 / K2 (K3 / K4), the
    launches exact, bf16 rows against float32 at cosine >= COS_MIN, int8
    held to the plain int8 route (phase 17's bar).  Returns the launches of
    each kernel in the two forwards and the img/s."""
    import torch
    from debias_vision_lang_torch.core.config import CLIPConfig, TextConfig, VisionConfig
    from debias_vision_lang_torch.models.clip import CLIP, init_clip_params
    from debias_vision_lang_torch.ops.quant import QuantizedCLIP

    t = SHAPE_TOWER
    cfg = CLIPConfig(name="ViT-H/14 widths",
                     vision=VisionConfig(image_size=t["px"], patch_size=t["patch"],
                                         width=t["width"], layers=t["layers"],
                                         heads=t["heads"], embed_dim=t["embed"]),
                     text=TextConfig(width=512, layers=1, heads=8, embed_dim=t["embed"]))
    t0 = time.perf_counter()
    model = CLIP(cfg)
    model.load_state_dict(init_clip_params(cfg, torch.Generator().manual_seed(0)))
    model = model.to(device).eval()
    print(f"phase 27 tower {cfg.name}: {t['layers']} layers D={t['width']} heads {t['heads']} "
          f"(hd {t['width'] // t['heads']}) patch {t['patch']} at {t['px']} px, S = "
          f"{cfg.vision.seq_len}, built in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator().manual_seed(27)
    imgs = torch.randn(t["b"], t["px"], t["px"], 3, generator=g).to(device)
    launches = {}
    with torch.no_grad():
        ref32 = model.encode_image(imgs, dtype=torch.float32).float()
        reset_all(fb, fbq)
        got16 = model.encode_image(imgs, dtype=torch.bfloat16).float()
        torch.cuda.synchronize()
        launches.update(fb.LAUNCHES)
        check(fb.LAUNCHES == {"attention_block": t["layers"], "attention_block_causal": 0,
                              "mlp_block": t["layers"]}
              and fb.CORE_ROUTES == {"short": t["layers"], "long": 0},
              f"phase 27 bf16 tower: launches {fb.LAUNCHES}, routes {fb.CORE_ROUTES}")
        cosine_check(f"phase 27 bf16 tower ({cfg.name}, B={t['b']}) vs float32", got16, ref32)
        qmodel = QuantizedCLIP(model)
        reset_all(fb, fbq)
        got8 = qmodel.encode_image(imgs).float()
        torch.cuda.synchronize()
        launches.update(fbq.LAUNCHES)
        check(fbq.LAUNCHES == {"attention_block_q": t["layers"], "attention_block_q_causal": 0,
                               "mlp_block_q": t["layers"]}
              and sum(fb.LAUNCHES.values()) == 0,
              f"phase 27 int8 tower: launches {fbq.LAUNCHES}, bf16 {fb.LAUNCHES}")
        int8_vs_plain_int8(f"phase 27 int8 tower ({cfg.name}, B={t['b']}) vs float32", qmodel,
                           imgs, got8, ref32)
        rate = {}
        for tag, fn in (("bf16 kernels", lambda: model.encode_image(imgs, dtype=torch.bfloat16)),
                        ("int8 kernels", lambda: qmodel.encode_image(imgs)),
                        ("plain bf16", lambda: model.encode_image(imgs, dtype=torch.bfloat16,
                                                                  fused=False)),
                        ("plain int8", lambda: qmodel.encode_image(imgs, fused=False))):
            ms = cuda_ms(fn, iters=3)
            rate[tag] = t["b"] / ms * 1e3
            print(f"phase 27 tower B={t['b']} {tag}: {ms:.3f} ms/batch, {rate[tag]:.1f} img/s "
                  f"({card})")
    del model, qmodel
    torch.cuda.empty_cache()
    return launches, rate


def shape_phase(card, device):
    """Phase 27 (see the section's head): the kernel checks, then the
    ViT-H/14-width tower.  Returns the kernels-line rows and the wall."""
    from debias_vision_lang_torch.ops import fused_block as fb
    from debias_vision_lang_torch.ops import fused_block_q as fbq

    t0 = time.perf_counter()
    rows = shape_checks(fb, fbq, device, card)
    rows += wide_checks(fb, fbq, device, card)
    launches, _ = shape_tower(fb, fbq, card, device)
    for row in rows:  # the ViT-H/14-width rows take the tower's counts
        if row["case"].startswith("ViT-H/14") and row["name"] in launches:
            row["launches"] = launches[row["name"]]
    wall = time.perf_counter() - t0
    print(f"phase 27 wall: {wall:.1f} s ({card})")
    return rows, wall


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU port only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from debias_vision_lang_torch.eval.measure import (eval_ranking, gen_prompts,
                                                      get_labels_img_embeddings,
                                                      get_prompt_embeddings)
    from debias_vision_lang_torch.data.loader import HostLoader
    from debias_vision_lang_torch.models.debias import DebiasCLIP
    from debias_vision_lang_torch.ops import _build
    from debias_vision_lang_torch.ops import attention as A
    from debias_vision_lang_torch.ops import fused_block as fb
    from debias_vision_lang_torch.ops import fused_block_q as fbq
    from debias_vision_lang_torch.ops.quant import resolve_compute
    from debias_vision_lang_torch.text import ByteTokenizer

    smoke_t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = smi()

    # 1. information
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    import importlib.util

    for mod in ("pandas", "regex", "PIL", "jax"):
        print(f"optional package {mod}: "
              f"{'present' if importlib.util.find_spec(mod) else 'absent'}")

    # 2. build: one nvcc per source, started together
    t0 = time.perf_counter()
    _build.load_all(["fused_block", "fused_block_q", "attention"])
    fb.build()
    fbq.build()
    A.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.BUILD_SECONDS or 'cached'})")
    for lib in ("fused_block", "fused_block_q", "attention"):
        print_ptxas(lib, _build.BUILD_LOG.get(lib, ""))
        sass_check(lib, _build.LIB_PATHS[lib])
    for lib in ("fused_block", "fused_block_q", "attention"):
        sass_check_long(lib, _build.LIB_PATHS[lib])

    # 3. bf16 kernels against their twins
    rows, text_ms, k1_long = kernel_phase(fb, device, card)

    # 4. main path; the port's native ingest is checked first (the library
    # keeps its Python fallback; the measurement does not take it unseen)
    decode = ingest_path()
    t0 = time.perf_counter()
    model, _, tokenizer, alias = DebiasCLIP.from_cfg(
        {"CLIP_ARCH": "openai/CLIP/ViT-B/16", "PRETRAINED": False,
         "NUM_DEBIAS_TOKENS": 2, "DEBIAS_POS": "prepend", "SEED": 0}, device=device)
    model.eval()
    tokenizer = tokenizer or ByteTokenizer()
    vis = model.clip_cfg.vision
    print(f"model {alias}: {sum(p.numel() for p in model.parameters())} params, "
          f"built in {time.perf_counter() - t0:.2f} s, tokenizer "
          f"{type(tokenizer).__name__}")
    loader = HostLoader(SyntheticFaces(N_IMAGES), batch_size=BATCH, num_workers=8,
                        native_n_px=vis.image_size, native_patch=vis.patch_size)
    prompts = gen_prompts()
    n_batches = N_IMAGES // BATCH
    torch.cuda.synchronize()
    fb.reset_launches()
    fbq.reset_launches()
    t0 = time.perf_counter()
    labels, img_embs = get_labels_img_embeddings(loader, model, n_px=vis.image_size,
                                                 dtype="bfloat16")
    prompt_embs = get_prompt_embeddings(model, tokenizer, prompts)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {**fb.LAUNCHES, **fbq.LAUNCHES}
    print(f"main path: {N_IMAGES} images + {len(prompts)} prompts in {main_s:.3f} s "
          f"(host clock, includes staging of in-memory uint8 images; {decode} for files); "
          f"launches {launches}")
    check(launches["attention_block"] == LAYERS * n_batches,
          f"attention_block launched {launches['attention_block']} times, "
          f"expected {LAYERS * n_batches}")
    check(launches["mlp_block"] == LAYERS * n_batches,
          f"mlp_block launched {launches['mlp_block']} times")
    check(img_embs.shape == (N_IMAGES, vis.embed_dim) and img_embs.is_cuda,
          f"image embeddings {tuple(img_embs.shape)}")
    check(prompt_embs.shape == (len(prompts), vis.embed_dim), "prompt embeddings")
    check_metrics("bf16", labels, img_embs, prompt_embs, eval_ranking)

    first = next(iter(loader)).images
    p8 = torch.from_numpy(first).to(device)
    with torch.no_grad():
        ref32 = model.encode_image(p8, dtype=torch.float32).float()
    cosine_check("bf16 kernel path vs float32 plain path, image embeddings",
                 img_embs[:BATCH], ref32)

    # 5. the bf16 text tower through the causal kernel
    tokens = torch.as_tensor(tokenizer(prompts), dtype=torch.long, device=device)
    fb.reset_launches()
    with torch.no_grad():
        txt16 = model.encode_text(tokens, dtype=torch.bfloat16).float()
        txt32 = model.encode_text(tokens).float()
    torch.cuda.synchronize()
    causal = fb.LAUNCHES["attention_block_causal"]
    print(f"bf16 text tower: causal attention_block launches {causal}, mlp_block "
          f"{fb.LAUNCHES['mlp_block']}")
    check(causal == LAYERS, "the bf16 text tower did not run the causal kernel")
    cosine_check("bf16 text tower vs float32", txt16, txt32)

    # 6. int8 kernels against their twins
    rows_q, text_ms_q = kernel_phase_q(fbq, device, card)

    # 7. the int8 main path: the same model and images, wrapped once
    t0 = time.perf_counter()
    qmodel, _ = resolve_compute(model, "int8")
    torch.cuda.synchronize()
    print(f"QuantizedCLIP built in {time.perf_counter() - t0:.2f} s")
    fb.reset_launches()
    fbq.reset_launches()
    t0 = time.perf_counter()
    labels_q, img_q = get_labels_img_embeddings(loader, qmodel, n_px=vis.image_size,
                                                dtype="int8")
    prompt_q = get_prompt_embeddings(qmodel, tokenizer, prompts)
    torch.cuda.synchronize()
    main_q_s = time.perf_counter() - t0
    launches_q = {**fb.LAUNCHES, **fbq.LAUNCHES}
    print(f"int8 main path: {N_IMAGES} images + {len(prompts)} prompts in {main_q_s:.3f} s "
          f"(host clock, includes decode); launches {launches_q}")
    for name in ("attention_block_q", "mlp_block_q"):
        check(launches_q[name] == LAYERS * n_batches,
              f"{name} launched {launches_q[name]} times, expected {LAYERS * n_batches}")
    check(sum(fb.LAUNCHES.values()) == 0, "the int8 path launched bf16 kernels")
    check(img_q.shape == (N_IMAGES, vis.embed_dim) and img_q.is_cuda,
          f"int8 image embeddings {tuple(img_q.shape)}")
    check(np.array_equal(labels_q, labels), "the int8 pass saw other labels")
    check_metrics("int8", labels_q, img_q, prompt_q, eval_ranking)
    cosine_check("int8 kernel path vs float32 plain path, image embeddings",
                 img_q[:BATCH], ref32)

    # 8. the int8 text tower ("int8-text") through the causal int8 kernel
    qtext, _ = resolve_compute(model, "int8-text")
    fbq.reset_launches()
    with torch.no_grad():
        txt8 = qtext.encode_text(tokens).float()
    torch.cuda.synchronize()
    causal_q = fbq.LAUNCHES["attention_block_q_causal"]
    print(f"int8 text tower: causal attention_block_q launches {causal_q}, mlp_block_q "
          f"{fbq.LAUNCHES['mlp_block_q']}")
    check(causal_q == LAYERS and fbq.LAUNCHES["mlp_block_q"] == LAYERS,
          "the int8 text tower did not run the causal int8 kernels")
    cosine_check("int8 text tower vs float32", txt8, txt32)

    # 9. K5 against its twin, then its long route on a joint tower's path
    attn_cases = kernel_phase_attn(A, device)
    long_launches = long_route_path(A, device)

    # 10-11. training on the K5 path, the plain float32 path and the bf16
    # fused path, from copies of the phase-4 model
    counters = (fb, fbq, A)
    sens = tokenizer(prompts)
    batches = train_batches(tokenizer, vis, device)
    run_k5 = run_trainer(model, sens, batches, counters, use_pallas=True)
    check_run("train K5 (use_pallas=True, float32)", run_k5)
    k5_per_step = 2 * LAYERS + 3 * LAYERS
    check(run_k5["counts"]["attention_pallas"] == TRAIN_STEPS * k5_per_step,
          f"K5 launched {run_k5['counts']['attention_pallas']} times in {TRAIN_STEPS} "
          f"steps, expected {TRAIN_STEPS * k5_per_step}")
    check(sum(v for k, v in run_k5["counts"].items() if k != "attention_pallas") == 0,
          "the K5 training path launched fused-block kernels")
    k5_model = run_k5.pop("model")
    del run_k5["trainer"]
    run_plain = run_trainer(model, sens, batches, counters, use_pallas=False)
    check_run("train plain (float32)", run_plain)
    check(sum(run_plain["counts"].values()) == 0, "the plain float32 path launched kernels")
    cos_k5 = cosine(run_k5["updates"][0], run_plain["updates"][0])
    cos_k5_g = cosine(run_k5["grad"], run_plain["grad"])
    print(f"first prompt step, K5 path vs plain float32: token gradient cosine "
          f"{cos_k5_g:.7f}, token update cosine {cos_k5:.7f} (bar {UPDATE_COS_K5} on both); "
          f"losses {run_k5['metrics'][0]['loss']} vs {run_plain['metrics'][0]['loss']}")
    check(min(cos_k5, cos_k5_g) >= UPDATE_COS_K5,
          "the K5 path's step drifts from the plain path's")
    del run_plain["trainer"], run_plain["model"], k5_model

    run_bf16 = run_trainer(model, sens, batches, counters, train_dtype="bfloat16",
                           embed_dtype="bfloat16")
    check_run("train bf16 fused blocks", run_bf16)
    want = {"attention_block": TRAIN_STEPS * 2 * LAYERS,
            "attention_block_causal": TRAIN_STEPS * 3 * LAYERS,
            "mlp_block": TRAIN_STEPS * 5 * LAYERS, "attention_pallas": 0,
            "attention_pallas_long": 0, "attention_block_q": 0,
            "attention_block_q_causal": 0, "mlp_block_q": 0}
    check(run_bf16["counts"] == want,
          f"bf16 training launches {run_bf16['counts']}, expected {want}")
    # Adam's first update is ~lr x sign(g): near-zero gradient elements flip
    # its sign, so the update is held by the share of flips, not its cosine
    u16, u32 = run_bf16["updates"][0], run_plain["updates"][0]
    cos_bf16 = cosine(u16, u32)
    flips = (u16.sign() != u32.sign()).double().mean().item()
    cos_bf16_g = cosine(run_bf16["grad"], run_plain["grad"])
    print(f"first prompt step, bf16 vs float32: token gradient cosine {cos_bf16_g:.6f} "
          f"(bar {UPDATE_COS_BF16}), token update sign flips {flips:.6f} of the elements "
          f"(bar {UPDATE_FLIP_MAX_BF16}), token update cosine {cos_bf16:.6f}")
    check(cos_bf16_g >= UPDATE_COS_BF16, "the bf16 gradient drifts from the float32 one")
    check(flips <= UPDATE_FLIP_MAX_BF16, "the bf16 update drifts from the float32 one")
    bf16_model = run_bf16.pop("model")
    del run_bf16["trainer"]
    w = torch.randn(len(prompts), vis.embed_dim, generator=torch.Generator().manual_seed(5)
                    ).to(device)
    grads = {}
    reset_all(*counters)
    for dt in (torch.bfloat16, torch.float32):
        out = bf16_model.encode_text(tokens, dtype=dt).float()
        grads[dt] = torch.autograd.grad((out * w).sum(), bf16_model.debias_tokens)[0]
    torch.cuda.synchronize()
    cos_g = cosine(grads[torch.bfloat16], grads[torch.float32])
    print(f"token gradient of the bf16 text tower (causal K1 launches "
          f"{fb.LAUNCHES['attention_block_causal']}): norm "
          f"{grads[torch.bfloat16].norm().item():.6g}, cosine with float32 {cos_g:.6f}")
    check(fb.LAUNCHES["attention_block_causal"] == LAYERS and grads[torch.bfloat16].norm() > 0
          and cos_g >= UPDATE_COS_BF16, "the bf16 token gradient does not reach the prompts")
    del bf16_model, grads
    torch.cuda.empty_cache()

    # 12. run_training at full width, cached and decoding
    from debias_vision_lang_torch.train.loop import run_training

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        t0 = time.perf_counter()
        ff_root = os.path.join(tmp, "fairface")
        write_fairface(ff_root, 256, 128)
        print(f"synthetic FairFace (256 train + 128 val at 224 px) written in "
              f"{time.perf_counter() - t0:.2f} s")
        runs = {}
        for cached in (True, False):
            m = copy.deepcopy(model)
            torch.cuda.synchronize()
            reset_all(*counters)
            t0 = time.perf_counter()
            res = run_training(model=m, tokenizer=tokenizer, attribute="gender", epochs=1,
                               batch_size=TRAIN_BATCH, data_path=ff_root,
                               checkpoint_dir=os.path.join(tmp, f"ckpt_{cached}"),
                               eval_every=4, eval_n_samples=None, use_pallas=True,
                               progress=False, cache_frozen_embeddings=cached)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launches_of(*counters)
            export = torch.load(res["export"], map_location="cpu", weights_only=True)
            ckpt = torch.load(os.path.join(res["checkpoint_dir"], "step_4.pt"),
                              map_location="cpu", weights_only=True)
            log = os.path.join(res["checkpoint_dir"], "logs", "metrics.jsonl")
            losses = [r["loss"] for r in map(json.loads, open(log)) if "loss" in r]
            print(f"run_training {'cached' if cached else 'decode'}: {res['steps']} steps "
                  f"in {wall:.2f} s (host clock, includes {decode} and 2 evals), best NDKL "
                  f"{res['best_ndkl']}, losses {losses}, launches {counts}")
            # cached: 4 embed-cache batches x 12 image layers + 4 steps x 36 text;
            # decode: 4 steps x (24 image + 36 text); the evals run float32 plain
            k5 = 4 * LAYERS + 4 * 3 * LAYERS if cached else 4 * 5 * LAYERS
            check(res["steps"] == 4 and res["embed_cache"] is cached,
                  f"run_training {cached}: {res['steps']} steps, cache {res['embed_cache']}")
            check(counts["attention_pallas"] == k5,
                  f"run_training launched K5 {counts['attention_pallas']} times, expected {k5}")
            check(math.isfinite(res["best_ndkl"]) and all(map(math.isfinite, losses)),
                  "run_training: non-finite loss or NDKL")
            check(type(export) is torch.Tensor and export.dtype == torch.float32
                  and tuple(export.shape) == (2, 512) and export.is_contiguous(),
                  f"the .pt export is not a bare [2, 512] float32 tensor: {type(export)}")
            check(ckpt["meta"]["step"] == 4 and torch.equal(ckpt["debias_tokens"],
                                                             m.debias_tokens.detach().cpu()),
                  "the step-4 checkpoint does not hold the trained tokens")
            runs[cached] = (export, losses, wall)
            del m
        diff = (runs[True][0] - runs[False][0]).abs().max().item()
        print(f"run_training cached vs decode: max token difference {diff}, losses "
              f"{'equal' if runs[True][1] == runs[False][1] else 'differ'}")
        check(diff == 0 and runs[True][1] == runs[False][1],
              "the cached and decode runs of run_training end apart")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)

    # 13. timings
    for row, counts in ([(r, launches) for r in rows + [k1_long]]
                        + [(r, launches_q) for r in rows_q]):
        if row["case"].startswith("ViT-B/16"):  # SLIP-L's: phase 17's counts
            row["launches"] = counts[row["name"]]
        print(f"time {row['name']} {row['case']}: kernel {row['ms']:.4f} ms, "
              f"plain twin {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}; the kernel at {row['bound_ms'] / row['ms']:.1%} of it) "
              f"({card})")
    # K1's and K3's long core at B=32 S=785 against the core's own bound
    core_bound, core_by = bound(*core_work(32, 12, FIT_JOINT_S))
    for row in [k1_long] + [r for r in rows_q if r.get("core_ms") is not None]:
        ms = row["core_ms"]
        print(f"time {row['name']} core {row['case']}: "
              + (f"{ms:.4f} ms (torch.profiler), bound {core_bound:.4f} ms ({core_by}; the "
                 f"core at {core_bound / ms:.1%} of it)" if ms else "not measured (the "
                 "profiler gave no device time)") + f" ({card})")
    text_work = {"attention_block causal": attention_block_work(319, 77, 512, causal=True),
                 "mlp_block": mlp_block_work(319, 77, 512, 2048),
                 "attention_block_q causal": attention_block_work(319, 77, 512, causal=True,
                                                                  weights="int8"),
                 "mlp_block_q": mlp_block_work(319, 77, 512, 2048, weights="int8")}
    for name, (k_ms, p_ms) in {**text_ms, **text_ms_q}.items():
        b_ms, b_by = bound(*text_work[name])
        print(f"time {name} B=319 S=77 D=512: kernel {k_ms:.4f} ms, plain twin "
              f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; the kernel at "
              f"{b_ms / k_ms:.1%} of it) ({card})")
    tower_img_s = {}
    with torch.no_grad():
        for label, tower, kw in (
                ("kernels (bf16)", model, {"dtype": torch.bfloat16}),
                ("kernels (int8)", qmodel, {}),
                ("plain int8 (torch._int_mm)", qmodel, {"fused": False}),
                ("plain bf16", model, {"dtype": torch.bfloat16, "fused": False}),
                ("plain float32", model, {"dtype": torch.float32})):
            ms = cuda_ms(lambda: tower.encode_image(p8, **kw), iters=5)
            tower_img_s[label] = BATCH / ms * 1e3
            print(f"image tower B={BATCH} {label}: {ms:.3f} ms/batch, "
                  f"{BATCH / ms * 1e3:.1f} img/s ({card})")
    for c in attn_cases:
        old = (f"; CUDA-core bound {c['bound_cuda_cores'][0]:.4f} ms "
               f"({c['bound_cuda_cores'][1]}), had the products run as f32 FMAs"
               if c["bound_cuda_cores"] else "")
        print(f"time {c['tag']}: kernel {c['ms']:.4f} ms, plain twin {c['plain_ms']:.4f} ms, "
              f"scaled_dot_product_attention {c['library_ms']:.4f} ms, bound "
              f"{c['bound'][0]:.4f} ms ({c['bound'][1]}; the kernel at "
              f"{c['bound'][0] / c['ms']:.1%} of it{old}) ({card})")
    for tag, run in (("plain float32", run_plain), ("K5 (use_pallas=True) float32", run_k5),
                     ("bf16 kernels", run_bf16)):
        steady = sum(run["times"][1:]) / len(run["times"][1:]) * 1e3
        print(f"train step B={TRAIN_BATCH} + 319 prompts, {tag}: {steady:.1f} ms/step "
              f"(mean of steps 2-{TRAIN_STEPS}; all {[round(t * 1e3, 1) for t in run['times']]}"
              f"; host clock) ({card})")
    for cached in (True, False):
        print(f"run_training {'cached' if cached else 'decode'}: {runs[cached][2]:.2f} s "
              f"({decode}; {card})")
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    rows_k5 = []
    for b, s, mask in ((319, 77, "causal"), (64, 197, "zero")):
        k5 = next(c for c in attn_cases
                  if c["dtype"] == "f32" and (c["b"], c["s"], c["mask"]) == (b, s, mask))
        check(k5["route"] == "short", f"{k5['tag']}: the main path's shapes take the short route")
        rows_k5.append({"name": "attention_pallas", "case": k5["tag"], "route": "cuda",
                        "source": "debias_vision_lang_torch/csrc/attention.cu",
                        "replaces": "debias_vision_lang_tpu/ops/attention.py:93",
                        "launches": run_k5["counts"]["attention_pallas"],
                        "max_abs_err": k5["err"], "ms": k5["ms"],
                        "plain_ms": k5["plain_ms"], "bound_ms": k5["bound"][0],
                        "bound_by": k5["bound"][1], "library_ms": k5["library_ms"]})
    for dt in ("f32", "bf16"):
        k5 = next(c for c in attn_cases
                  if c["dtype"] == dt and (c["b"], c["s"], c["mask"]) == (8, 785, "zero"))
        check(k5["route"] == "long", f"{k5['tag']}: S = 785 takes the long route")
        rows_k5.append({"name": "attention_pallas_long", "case": k5["tag"], "route": "cuda",
                        "source": "debias_vision_lang_torch/csrc/attention.cu",
                        "replaces": "debias_vision_lang_tpu/ops/attention.py:93",
                        "launches": long_launches[dt], "max_abs_err": k5["err"], "ms": k5["ms"],
                        "plain_ms": k5["plain_ms"], "bound_ms": k5["bound"][0],
                        "bound_by": k5["bound"][1], "library_ms": k5["library_ms"]})

    # 14. the embedding cache on the main path; 15. the adversary ablation
    cache_phase(model, tokenizer, decode, card)
    abl_s = ablation_phase(card)
    # 16. serving
    t0 = time.perf_counter()
    serve_phase(model, tokenizer, prompts, card, tower_img_s["kernels (bf16)"])
    serve_s = time.perf_counter() - t0
    # 17. SLIP-ViT-L/16 at full width and depth; its launches complete the
    # SLIP-L rows of the kernels line
    t0 = time.perf_counter()
    slip_launches = slip_phase(model.clip, prompts, card, device)
    slip_s = time.perf_counter() - t0
    # 18. the ModifiedResNet family; RN50x4's launches complete the D=640 rows
    t0 = time.perf_counter()
    rn_launches = resnet_phase(prompts, card, device)
    rn_s = time.perf_counter() - t0
    # 19. the Frozen-in-Time video family; its int8 joint measurement's
    # launches complete the FiT rows (K3 on its long core, K4 at S = 785)
    t0 = time.perf_counter()
    fit_launches = fit_phase(prompts, card, device)
    fit_s = time.perf_counter() - t0
    # 20. distribution: the (data, model) mesh, sharded metrics, the world
    dist_s = dist_phase(model, qmodel, tokenizer, prompts, card, device)
    # 21. the "auto" rung: every registry arch not run before at every rung,
    # K1-K4 at their shapes, auto through every entry point
    rung_rows, rung_s = rung_phase(model, tokenizer, prompts, card, device, tower_img_s)
    # 22. tensor parallel: the split kernels and KB (a) 6, the float32,
    # bf16 and int8 towers under virtual (data, model) meshes, the dryrun step
    tp_rows, tp_s = tp_phase(model, tokenizer, prompts, card, device)
    # 23. KB (a) 1-4, the int8 kernel experiments: each against its twin,
    # timed beside K3 / K4, and on the scripts' towers of the phase-4 model
    kb_rows, kb_s = kb_int8_phase(model, card, device)
    # 24. K4's F-split, KB (a) 5, the one-call int8 layer and q_ilp4's
    # post-P V division: each against its twin, timed, and on the towers
    split_rows, split_s = split_phase(model, card, device)
    # 25. benchmarks/q_attribution.py's MXU-only and VPU-only blocks: each
    # against its twin, timed, and the script's six towers
    attr_rows, attr_s = attr_phase(model, card, device)
    # 26. the port's bench: the root bench.py's six configurations, the
    # headline's batches and the CLI
    bench_s = bench_phase(card, device)
    # 27. K1-K4 at the shapes of public models' widths the JAX kernels take,
    # and a ViT-H/14-width tower at bf16 and int8
    shape_rows, shape_s = shape_phase(card, device)
    for row in rows + rows_q:
        if row["case"].startswith("RN50x4"):
            row["launches"] = rn_launches[row["name"]]
        elif row["case"].startswith("FiT"):
            row["launches"] = fit_launches[row["name"]]
        elif row["launches"] is None:
            row["launches"] = slip_launches[row["name"]]
    print(json.dumps({"kernels": rows + rows_q + rows_k5 + rung_rows + tp_rows + kb_rows
                      + split_rows + attr_rows + shape_rows}))
    total_s = time.perf_counter() - smoke_t0
    print(f"smoke wall time {total_s:.1f} s, of it the ablation {abl_s:.1f} s, serving "
          f"{serve_s:.1f} s, SLIP-L {slip_s:.1f} s, the ResNets {rn_s:.1f} s and "
          f"Frozen-in-Time {fit_s:.1f} s, distribution {dist_s:.1f} s, the rung sweep "
          f"{rung_s:.1f} s, tensor parallel {tp_s:.1f} s, KB (a) 1-4 {kb_s:.1f} s, "
          f"phase 24 {split_s:.1f} s, phase 25 {attr_s:.1f} s, phase 26 {bench_s:.1f} s, "
          f"phase 27 {shape_s:.1f} s"
          + (" (past 10 minutes)" if total_s > 600 else ""))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-rank"]:
        sys.exit(dist_rank(int(sys.argv[2]), *sys.argv[3:6]))
    sys.exit(main())
