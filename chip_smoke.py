#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``diffsim_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, on a machine with a CUDA card

Phases, each of which fails the run (non-zero exit, no result line) if anything in it fails:

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. the build: every ``diffsim_tpu_torch/csrc/*.cu`` compiled by nvcc for sm_90a, in parallel;
3. K1 ``fused_self_attention`` at the SD-1.5 main-path shapes (B = 24: 4 triplets x 6 CFG
   rows), the SDXL ones (B = 12: 2 triplets) and DiT-XL/2's (48, 16, 1024, 72) (8 triplets x 6
   rows; head dim 72 runs as the kernel's 80-wide instantiation), at S = 1280, in float32, and
   at every head dim it takes in bf16 and in float32, against its plain version; timed beside
   the plain version, ``F.scaled_dot_product_attention`` (a yardstick only; the port never
   calls it), its previous design (v2, ``csrc/attention_v2.cu``, also held to the plain
   version: in float32 the FMA kernel that the 3xTF32 design replaced) and the card's bound;
4. K2 ``fused_geglu_ff`` at its main-path shapes, the same way, beside its previous design
   (v2, ``csrc/geglu_ff_v2.cu``) and, as information, cuBLAS's two projections with PyTorch's
   elementwise GEGLU between them (no single PyTorch call computes GEGLU-FF, so K2 has no
   library time); at the same shapes in float32 (3xTF32, atol = rtol = 1e-4) beside its first,
   FMA design (``geglu_ff_f32_v1_fwd``) and cuBLAS's float32 path with TF32 off; and at ragged
   row counts and other widths in both dtypes;
5. K3 ``cross_self_partials`` (the fused readout) at the SDXL tap, (80, 1024, 64) bf16, in
   both similarities, at the SD-1.5 up-block-2/3 taps, at the DiT-XL/2 tap of its main path,
   (256, 1024, 72), and in float32 (3xTF32, ``csrc/fused_readout_f32.cu``) at the taps of the
   float32 scoring calls (DiT-XL/2's, SDXL's and SD-1.5's up-block-2 (64, 1024, 80)),
   scores against its plain version and its previous design (bf16: v2,
   ``csrc/fused_readout_v2.cu``; float32: the first, FMA design, ``fused_readout_f32_v1_fwd``);
   the kernel timed apart from the wrapper's per-pair torch epilogue (by CUPTI only), beside
   that design and, as information, two 4-D ``scaled_dot_product_attention`` calls (flash in
   bf16, the memory-efficient backend in float32) plus the reduction;
6. K4 ``streaming_self_attention`` at the 1024 px VAE mid attention (2, 1, 16384, 512) in
   float32 (the SDXL main path) and bf16, and at a ragged S = 8448, with SDPA as its library
   time and its previous design (v2) beside it; in bf16 also at (4, 1, 16384, 512), at the
   768 px (2, 1, 9216, 512) and over D 168-512 at S = 8192 (atol 2e-3, rtol 1e-2), and on sharp
   logits (atol = rtol = 1e-2) beside a control, one 32-key slice left out, that must fail it;
6b. K4 wide heads (``csrc/streaming_attention_wide.cu``): at (2, 1, 16384, 1024) and (2, 1, 16384,
   768) in float32 (atol 1e-5) and bf16 (atol 2e-3, rtol 1e-2), in both modes (the bf16_probs
   mode within 1e-2 of the plain version and against the kernels' own rounding), timed beside
   SDPA and the bound; at S = 8192 over D 520-1024 in both dtypes and float32 D 168, 200, 328;
   on sharp logits at (1, 1, 8192, 1024) in bf16 beside its control; and through a VAE encoder
   whose last block is 1024 wide (``VAEConfig(block_out_channels=(128, 256, 512, 1024))``) at
   1024 px on 2 images in float32 and bf16: 1 K4 launch a chunk, the moments held to the same
   encode with the plain K4 beside a control (V in place of the attention) that must fail the
   limit;
6c. K1-K3 at the shapes their kernels take only through the wrapper's launch plan: K1 at D 20,
   36, 100, 156 (zero-padded to 8) and S 64, 256 in both dtypes and both modes, K3 at D 20, 100
   (both similarities), K2 at C 40, 200 (zero-padded to 32 with the weights, W1's h and gate
   halves apart), and past the grid's 65535 rows in two launches (K1 at B*H = 65536, K3 at
   N = 65536, K2 at 65535 x 64 + 64 rows, the rows on both sides of each boundary checked), each
   against its plain version at the K1-K3 phases' limits with its shape, contiguity and launches;
   one call a kernel through its route (``ops.attention.sdpa``, ``GEGLUFeedForward``,
   ``metrics.readout.cross_attention_score``); K1's gradient at D 36 under autograd;
7. end-to-end correctness, card vs CPU from one seeded numpy weight tree and one
   ``noise_override``, in float32 with TF32 off: a tiny ``DiffSimSD15`` at 32 px (K1, K2), a
   tiny ``DiffSimXL`` at 256 px (all four kernels) and a tiny ``DiffSimDiT`` at 128 px whose tap
   has DiT-XL/2's head dim 72 and 1024 tokens (K1, K3);
8. the SD-1.5 main path at full width: ``DiffSimSD15(img_size=512)`` in bf16 with random
   weights drawn on the card, ``score_triplet_batch`` on 4 triplets with the canonical CUTE
   arguments, ``score_batch`` on 2 pairs and ``diffsim`` on two PNG paths (8 K1, 4 K2 per UNet
   forward), then ``score_batch`` at the up-block-2 tap (``fix_layer_collapse``), through K3;
9. the SDXL main path at full width: ``DiffSimXL(img_size=1024)`` in bf16 with the float32
   VAE, ``score_triplet_batch`` on 2 triplets with the ``bench_backbones.py`` arguments,
   ``score_batch`` on 2 pairs and ``diffsim_score`` on two PNG paths, each with its exact
   launch counts of all four kernels, a profile of one triplet call, and the share of the
   call that its float32 VAE encode takes; then ``score_triplet_paths`` on the same two
   triplets written to disk, through the device moment cache (within 1e-2 of the fresh path,
   and an all-hit rescore bit for bit); then SDXL with ``--xl_vae_bf16`` built through
   ``cli.args`` and ``metrics.registry`` (2 bf16 K4 a triplet call), its VAE moments and scores
   held to the same call with the plain K4 (the moments' limit failed by a control, V in place
   of the mid attention), its cached path, and its VAE encode's share of the call;
10. the bf16_probs mode (``--bf16_softmax``) of K1 at its SD-1.5 and SDXL shapes and in float32,
   and of K4 at the 1024 px VAE shape in both dtypes and at the 768 px SD-1.5 VAE shape,
   against their plain versions (atol = rtol = 1e-2), then on inputs with exact logits and
   each row's max at key 0 against a reference that rounds where the kernels round (float32
   within 1e-5, bf16 within half an output ulp, and at most a tenth of the exact mode's
   disagreement with it), timed beside the exact mode and, K1 in float32, beside its previous
   (FMA) design;
11. the 2AFC CLI at full SD-1.5 width: ``run_benchmark("cute", --preset cute ...)`` over a
   CUTE-shaped tree of 36 random 640 x 480 JPEGs (60 comparisons), through the device moment
   cache (one miss per image, the rest hits; 8 K1 and 4 K2 per UNet forward, no K3 or K4),
   again with ``--no_device_cache`` (scores within 1e-2), an all-hit rescore (bit for bit),
   and with ``--bf16_softmax`` (every K1 launch in the mode; scores within 0.05 of the exact
   run, not all equal); the SD-1.5 pair path in fast mode at 768 px, whose VAE mid attention
   (9216 tokens) runs K4 in the mode; and the device-memory guard's per-triplet constant held
   above the slope of the peak memory of the triplet path, measured between two triplet counts;
12. the DiT-XL/2 main path at full width: ``DiffSimDiT(img_size=512)`` in bf16 with random
   weights drawn on the card, ``score_triplet_batch`` on 8 triplets with the
   ``bench_backbones.py`` arguments (tap block 13, t = 600, cosine, seed 2334; 13 K1 at
   (48, 16, 1024, 72) and 4 K3 per call, no K2 or K4), ``score_batch`` on 2 pairs,
   ``diffsim_score`` on two PNG paths, a profile and the VAE encode's share of the call,
   ``score_triplet_paths`` through the moment cache (all misses, then all hits bit for bit) and
   the device-memory guard's slope for ``DiffSimDiT.hbm_scale``;
12b. the float32 scorers at full width (``dtype=torch.float32``, random weights): SD-1.5 at 512
   px on 4 triplets at the canonical tap (8 K1, 4 K2) and at the up-block-2 tap (11 K1, 6 K2, 4
   K3), SDXL at 1024 px on 2 triplets (45 K1, 4 K2, 4 K3, 3 K4) and DiT-XL/2 at 512 px on 8
   triplets (13 K1, 4 K3), every launch on float32 tensors; each call's scores held to the same
   call with K2's and K3's plain versions within 1e-5 + 1e-5 of the distance, beside a control
   (GEMM2's first 32-column k panel and keys [32, 64) of every 64-key tile left out) that must
   fail that limit; a repeat bit for bit, its time and peak memory beside the bf16 scorer's
   time; each cached path; the device-memory guard's slope for each float32 scorer (SD-1.5 at 8
   and 16 triplets, SDXL at 2 and 4, DiT-XL/2 at 8 and 16), held below the guard's constants;
13. the CLI with ``--metric dit`` (``cute --preset cute``, the same 36 JPEGs, through the moment
   cache: one miss per image);
14. the checkpoint converter on this machine, which has neither ``safetensors`` nor
   ``ml_dtypes``: ``python -m diffsim_tpu_torch.cli.convert dit`` on a ``torch.save`` DiT
   checkpoint of DiT-XL/2's widths cut to one block and a BF16 safetensors VAE written here byte
   by byte, and on the same DiT as safetensors; the ``.npz`` loads through the ``--weights``
   reader into a ``DiffSimDiT`` on the card, equal to the checkpoint's weights, and scores;
15. this slice's paths, card vs CPU at tiny width from one seeded numpy tree and one
   ``noise_override``, in float32 with TF32 off: SD-1.5 with a tiny IP-Adapter-plus (K1, K2),
   masked queries at 32 px and at 64 px (whose 1024-token tap takes K3), ``score_feats_batch``
   (``diffeats``), and SDXL with a tiny IP-Adapter-plus at 256 px (K1, K2, K4);
16. at full width on the main-path scorers: SD-1.5 at 512 px with CLIP ViT-H/14 and the
   ``sd15_plus`` Resampler, ``score_batch(ip_adapter=True)`` on 2 pairs with the ``ipref``
   preset's arguments (9 K1, 4 K2: the tap block's attn1 runs before its attn2 stops), a repeat
   bit for bit, its time and peak memory; masked ``score_batch`` at the canonical tap and at up
   block 2 (K3), ``score_feats_batch`` and ``tap_values`` on a PNG; SDXL at 1024 px with ViT-H/14
   and the ``sdxl_plus`` Resampler, ``score_batch(ip_adapter=True)`` on 2 pairs with the
   ``bench_backbones.py`` arguments (46 K1, 4 K2, 2 K4, no K3: 16 image keys are not square);
17. the CLI over the 36 JPEGs with ``--ip_adapter``, ``--use_mask --mask_path`` (a mask tree
   written here), ``--use_mask`` (the border-statistics heuristic) and ``--metric diffeats``,
   each on the pair path with its exact launches;
18. the baseline metrics, card vs CPU at tiny width from one seeded numpy tree per model, in
   float32 with TF32 off (|d score| <= 1e-4, no K1-K4 launch): clip_i, clip_t, clip_cross,
   clipfeats, dino, dinov1, dino_cross, dinofeats, lpips, gram (two aspect ratios in one ragged
   batch) and cute on a tiny U^2-Net's mattes, whose saliency is held within 1e-4;
19. the convert CLI's baseline families (clip, dinov2 --size base, dinov1, vgg19, lpips --vgg,
   u2net) in a process where importing jax, safetensors or ml_dtypes raises, on checkpoints of
   the published names and full widths written here; each ``.npz`` through the ``--weights``
   reader into its scorer on the card, equal to the checkpoint and scoring;
20. the baselines at their published widths with random weights, 16 pairs each: CLIP B/32 at
   224 px (image and text towers), DINOv2-small and DINO v1 ViT-S/8 at 224 px, LPIPS (VGG-16)
   at 512 px, the VGG-19 Gram at 512 px shortest side (683 x 512 and 512 x 512 buckets), FFA
   with DINOv2-base at 336 px and the converted U^2-Netp at 320 px: no K1-K4 launch, a repeat
   bit for bit, each call's time and peak device memory, a profile of the slowest call;
21. the CLI over the 36 JPEGs with every baseline metric, ``--metric cute --matting_weights``
   and ``diffsim --use_mask --matting_weights`` (the converted U^2-Netp), and ``--metric
   ensemble`` (diffsim through the moment cache, clip_i, dino; its K1 / K2 launches predicted
   from the cached CLI run's forwards), each with its pairs/s;
22. K1 under autograd (DiT training): ``torch.autograd.grad`` through its ``FusedSelfAttention``
   Function (the kernel's forward; the backward the kernels of ``csrc/fused_attention_bwd.cu``,
   the JAX ``_fused_bwd``, one launch a call) against the same through
   ``fused_self_attention_plain``, and the backward kernel against
   ``fused_self_attention_bwd_plain``, bit for bit on a second call, at DiT-XL/2's 256 px
   training site (32, 16, 256, 72) and at (2, 3, 256, 72) and (2, 3, 1024, 80), in float32 and
   bf16; the backward alone at D 36 (zero-padded), D 160, 1024 tokens and B*H = 65536 (two
   launches); the output's ``grad_fn`` is the Function; the forward timed beside SDPA and its
   bound (float32: also beside the previous FMA design, at the training site and the
   sampler's), the backward beside its first design (``csrc/fused_attention_bwd_v1.cu``, in
   turns), its plain version, SDPA's backward and its bound, each design split by kernel, with
   the backward kernels' registers and spills from the build's ptxas report;
23. one DiT training step at tiny width (head dim 72 at 256 tokens, so K1 and its backward
   kernel route: 3 K1 and 2 backward launches asserted), card vs CPU from one seeded tree in
   float32 with TF32 off and injected noise, t and label drop: the loss, every gradient, the
   AdamW step and the EMA;
24. ``dit_train`` at DiT-XL/2 256 px, batch 32, over 96 random JPEGs in 2 class folders: float32
   (4 steps, a checkpoint every 2, the SD VAE encoder from a seeded ``.npz`` of its published
   widths), ``--resume`` from step 2 (the step count continues), ``--bf16`` (3 steps, a profile
   of one step) and ``--remat`` (2 steps, the random encoder); 28 K1 launches a step (56 with
   remat) and 28 of its backward kernel, none of K2-K4 asserted, finite losses, step time,
   images/s and peak memory;
25. ``dit_sample`` from that checkpoint with the ``.npz``'s ``vae_decoder``: the 8 default
   labels at CFG 4.0 and 50 steps (ancestral, then ``--ddim``) into a PNG grid of 256 px images,
   and ``--num_fid_samples 16 --per_batch 8`` into an ``arr_0`` of (16, 256, 256, 3) uint8; 28
   K1 launches a denoising step, none from the decoder, ms a step and images/s.
26. SAM at tiny width, card vs CPU on one seeded tree in float32 with TF32 off: ``predict``'s
   mask logits and IoU within 1e-4, ``SamMasking``'s mattes of two aspect ratios equal except
   where the CPU's resampled logit is within 1e-4 of 0; no K1-K4 launch;
27. SAM ViT-H at full width, 1024 px, random weights drawn on the card: ``SamMasking`` on four
   images of different aspect ratios, each mask's time, ``predict``'s device time and profile,
   the peak device memory, no K1-K4 launch; one image's multimask logits and IoU held to the
   same module in float64 on the card (1e-3 of the largest), the flipped mask pixels counted;
28. ``python -m diffsim_tpu_torch.cli.convert sam`` on a ``torch.save`` checkpoint of the
   published sam_vit_b names and widths in the process where jax, safetensors and ml_dtypes
   raise on import (ViT-B picked by the width; the ``.npz`` equal to the checkpoint in bf16), then
   ``cute --preset cute --use_mask --sam_weights`` at full SD-1.5 width over the 36 JPEGs (32 K1,
   16 K2);
29. the scoring service (``cli/serve.make_server``) at full SD-1.5 width, 512 px, on an ephemeral
   localhost port: three concurrent clients by path and by base64 fused into fewer rounds than
   requests (8 K1 and 4 K2 a round), an oversize request in rounds of 4 and 2, ``/healthz``, a
   bad path answered 400 while the server keeps serving, every served score within 1e-3 of the
   scorer's own ``score_batch`` on the same pixels; request latency p50 and max;
30. ``retrieval rank`` at full SD-1.5 width: one query against nine of the JPEGs through the
   moment cache (10 misses, 16 K1 / 8 K2) and by the pair route (24 / 12), scores within 1e-3
   and the rankings in the same order wherever two scores are further apart (the spread of the
   scores and the number of such pairs printed: with random weights the scores barely depend
   on the image);
31. the CLI under ``torchrun --standalone --nproc_per_node 1`` (an NCCL group of one rank), whose
   worker is this script with ``--torchrun-cli ARGS``: the CLI's ``main`` on ``cute --preset
   cute`` over the 36 JPEGs, its results within 1e-3 of the one-process run's, 32 K1 and 16 K2;
32. the same CLI run on two ranks on cuda:0 (this machine has one card), spawned here and joined
   in a gloo group: each call's triplets sharded, 30 comparisons a rank, rank 0's results
   within 1e-3 of the one-process run's and every comparison decided beyond twice the gap
   decided the same, each rank's launches;
33. the scoring service on two ranks: rank 0 serves, rank 1 follows its rounds; a warm-up round,
   then one burst of 3 requests, the scores within 1e-3 of the one-process service's, both
   ranks scoring rows;
34. ``dit_train --distributed`` on two ranks at DiT-XL/2 256 px, global batch 32: 3 float32
   steps whose losses are within 1e-4 relative of the one-process run's (rank 0's checkpoint
   at step 2 within 4e-4 of its weights), and 1 ``--bf16`` step within 5e-3; 28 K1 and 28
   backward launches a step on each rank;
35. ``dit_sample --ddim`` on two ranks from the training checkpoint: the decoded images within
   1e-2 of the one-process run's.
Two ranks on one card show that the sharded paths are right and what they cost, not how they
scale: a speed-up across cards cannot be measured on one card.

The line before the last is one JSON object ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. A kernel's time (``ms``), its library call's and its v2's are
device times over 20 back-to-back calls after 3 warm-ups (the first launch sets shared-memory
limits), divided by 20: the CUPTI durations of the kernels each call launched, from
``torch.profiler``, which host work cannot enter; or, where torch.profiler cannot be used
(another profiler already runs in the process) or records no kernel, the time between two CUDA
events around the 20 calls, which covers the whole call. Each timed row and each kernel's totals
name the method under ``timing``. They are timed in turns, twice, and each keeps its lower
reading. ``call_ms`` is the whole wrapper call between two CUDA events (median of 20),
host work included, as information; plain versions are timed that way too (5 calls for the
slowest). Each phase header prints the seconds since the script started (so each phase's time
is the difference of two headers) and the card's SM clock, power and throttle reasons: a card
held at its power limit lowers its clock. A bound is the largest of three times at the H100 SXM's
published dense peaks: the products (989 TFLOP/s bf16 tensor cores; K1 and K4 float32 three
TF32 passes at 495 TFLOP/s, 2.5 on average in their bf16_probs modes, whose P V takes two; 67
TFLOP/s float32 outside the tensor cores, which the FMA designs ran on), the exponentials
(3.9e12/s on the special-function units, FlashAttention-3 section 1: b h s^2 for K1 and K4,
twice that per direction for K3) and the bytes (3.35 TB/s).
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import dataclasses
import functools
import gc
import json
import os
import pickle
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from diffsim_tpu_torch.cli import dit_sample, dit_train, retrieval, serve
from diffsim_tpu_torch.cli.args import arg_parse
from diffsim_tpu_torch.cli.main import run_benchmark
from diffsim_tpu_torch.convert import bridge
from diffsim_tpu_torch.convert.store import save_params
from diffsim_tpu_torch.core.image import process_image_u8
from diffsim_tpu_torch.core.tokenizer import HashTokenizer
from diffsim_tpu_torch.data import benchmarks
from diffsim_tpu_torch.data.imagefolder import ImageFolderDataset
from diffsim_tpu_torch.metrics import registry
from diffsim_tpu_torch.metrics.clip_i import CLIPPair, CLIPScore
from diffsim_tpu_torch.metrics.dino import DinoScore, Dinov2Score
from diffsim_tpu_torch.metrics.diffsim_dit import DiffSimDiT
from diffsim_tpu_torch.metrics.diffsim_sd15 import DiffSimSD15
from diffsim_tpu_torch.metrics.diffsim_xl import DiffSimXL
from diffsim_tpu_torch.metrics.ffa import (
    ForegroundFeatureAveraging,
    MattingInversionWarning,
    U2NetMatting,
)
from diffsim_tpu_torch.metrics.lpips import LPIPS, LPIPSNet
from diffsim_tpu_torch.metrics.sam_masking import SamMasking, infer_config, resampled_logits
from diffsim_tpu_torch.metrics.vgg_gram import VGGGram
from diffsim_tpu_torch.metrics.scorer_base import build_module, to_device_pixels
from diffsim_tpu_torch.models.clip_text import CLIPText, CLIPTextConfig
from diffsim_tpu_torch.models.clip_vision import CLIPVision, CLIPVisionConfig
from diffsim_tpu_torch.models.dinov2 import Dino, DinoConfig
from diffsim_tpu_torch.models.dit import DiT, DiTConfig
from diffsim_tpu_torch.models.ip_adapter import Resampler, ResamplerConfig, attn2_modules
from diffsim_tpu_torch.models.sam import Sam, SamConfig
from diffsim_tpu_torch.models.u2net import U2Net, U2NetConfig
from diffsim_tpu_torch.models.unet import UNet, UNetConfig
from diffsim_tpu_torch.models.vae import (
    Decoder,
    Encoder,
    VAEConfig,
    default_chunk,
    encode_chunked,
)
from diffsim_tpu_torch.models.vgg import VGG, VGG16_CFG, VGG19_CFG
from diffsim_tpu_torch.metrics.readout import cross_attention_score
from diffsim_tpu_torch.ops import attention as tattn
from diffsim_tpu_torch.ops import kernels
from diffsim_tpu_torch.ops.kernels import attention as kattn
from diffsim_tpu_torch.ops.kernels import build, readout
from diffsim_tpu_torch.ops.kernels import ff as kff
from diffsim_tpu_torch.ops.kernels.attention import (
    fused_self_attention, fused_self_attention_bwd, fused_self_attention_plain, round_bf16)
from diffsim_tpu_torch.ops.kernels.attention_stream import (
    streaming_self_attention,
    streaming_self_attention_plain,
)
from diffsim_tpu_torch.ops.blocks import GEGLUFeedForward, IPProjection
from diffsim_tpu_torch.parallel import mesh
from diffsim_tpu_torch.ops.kernels.ff import fused_geglu_ff, fused_geglu_ff_plain
from diffsim_tpu_torch.ops.kernels.readout import (
    cross_self_partials,
    fused_direction_score,
    fused_direction_score_plain,
)
from diffsim_tpu_torch.runtime import hbm_guard
from diffsim_tpu_torch.runtime.device_cache import resolve_cached_chunk
from diffsim_tpu_torch.train.dit_trainer import DiTTrainer, TrainConfig

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM: bf16 tensor, FP32 SIMT
PEAK_TF32 = 495e12  # H100 SXM dense TF32 tensor cores: K1 and K4 float32 run 3xTF32 passes
PEAK_EXP = 3.9e12  # exp/s of the H100 SXM's special-function units (FlashAttention-3, section 1)
PEAK_BYTES = 3.35e12  # HBM3 bandwidth, H100 SXM
CUTE = dict(prompt="The photo of a cat", target_block="up_blocks", target_layer=(0,),
            target_step=600, similarity="cosine", seed=2334)
XL_ARGS = dict(prompt="The photo of a benchmark", target_block="up_blocks",
               target_layer=(0, 1, 1), target_step=900, similarity="cosine", seed=2334)
BATCH = 24  # SD-1.5: 4 triplets x 3 images x 2 CFG halves
XL_T, XL_BATCH = 2, 12  # SDXL: 2 triplets (bench_backbones.py) x 3 images x 2 CFG halves
# DiT-XL/2 at 512 px (bench_backbones.py): 8 triplets x 3 images x [cond, null class], tap block 13
DIT_ARGS = dict(target_layer=13, target_step=600, similarity="cosine", seed=2334)
DIT_T, DIT_BATCH = 8, 48
# (batch, heads, tokens, head dim): launches per SD-1.5 forward (canonical tap), per SDXL
# triplet call (tap (0, 1, 1)) and per DiT-XL/2 triplet call (13 blocks before the tap)
K1_SITES = {(BATCH, 8, 4096, 40): (2, 0, 0), (BATCH, 8, 1024, 80): (2, 0, 0),
            (BATCH, 8, 256, 160): (4, 0, 0), (XL_BATCH, 10, 4096, 64): (0, 4, 0),
            (XL_BATCH, 20, 1024, 64): (0, 41, 0), (DIT_BATCH, 16, 1024, 72): (0, 0, 13)}
K2_SITES = {(BATCH * 4096, 320): (2, 0), (BATCH * 1024, 640): (2, 0),
            (XL_BATCH * 4096, 640): (0, 4)}  # (rows, channels)
K3_MAIN = (XL_T * 2 * 20, 1024, 64)  # (P * B * heads, tokens, head dim) at the SDXL tap
K3_DIT = (DIT_T * 2 * 16, 1024, 72)  # the same at the DiT-XL/2 tap, 512 px
K4_MAIN = (2, 1, 16384, 512)  # one VAE chunk of two 1024 px images
K4_768 = (2, 1, 9216, 512)  # the VAE mid attention of one SD-1.5 pair at 768 px
# the keys whose row sums K4's bf16_probs mode rounds (csrc/streaming_attention.cu): a float32
# tile, and in bf16 one consumer warpgroup's 32 keys of a 64-key tile. Its truncating
# tensor-core steps are check_rounding's default: in bf16 one accumulator takes every tile's
# P V (S / 16 k16 steps), in float32 each 8-key chunk's products are a fresh sum
K4_SUM_TILE = {torch.float32: 64, torch.bfloat16: 32}
# K1 float32's truncating tensor-core steps in one P V sum in its bf16_probs mode: a fresh sum
# per 64-key tile, 8 k8 steps of 2 TF32 products (csrc/fused_attention.cu)
K1_F32_TC_STEPS = 64 // 8 * 2
# the bf16_probs mode of K1 at the SD-1.5 main-path sites and one SDXL site, in bf16
K1_FAST_SITES = [(BATCH, 8, 4096, 40), (BATCH, 8, 1024, 80), (BATCH, 8, 256, 160),
                 (XL_BATCH, 20, 1024, 64)]
CLI_BATCH = 16  # comparisons per scoring call of the CLI phase (--batch_size)
# exact launches of each scoring call, derived from the configs (each kernel-routed site of
# the forward up to the tap, the readout's two directions per pair score, one K4 per VAE chunk)
NONE = dict.fromkeys(("fused_self_attention", "fused_geglu_ff", "cross_self_partials",
                      "streaming_self_attention", "fused_self_attention_bwd"), 0)
SD15_CALL = {**NONE, "fused_self_attention": 8, "fused_geglu_ff": 4}
SD15_K3_CALL = {**NONE, "fused_self_attention": 11, "fused_geglu_ff": 6, "cross_self_partials": 2}
XL_FORWARD = {**NONE, "fused_self_attention": 45, "fused_geglu_ff": 4}
XL_TRIPLET_CALL = {**XL_FORWARD, "cross_self_partials": 4, "streaming_self_attention": 3}
XL_PAIRS_CALL = {**XL_FORWARD, "cross_self_partials": 2, "streaming_self_attention": 2}
XL_ONE_PAIR_CALL = {**XL_FORWARD, "cross_self_partials": 2, "streaming_self_attention": 1}
# with --xl_vae_bf16 the VAE encodes 4 bf16 images a slice at 1024 px (models/vae.default_chunk:
# 8 MiB of input pixels), so a triplet call's six images take two K4 launches, at
# (4, 1, 16384, 512) and (2, 1, 16384, 512)
XL_BF16_TRIPLET_CALL = {**XL_TRIPLET_CALL, "streaming_self_attention": 2}
K4_XL_BF16 = ((4, 1, 16384, 512), K4_MAIN)
TINY_SD15_CALL = {**NONE, "fused_self_attention": 3, "fused_geglu_ff": 3}  # K1: 2 UNet, 1 VAE
TINY_XL_CALL = {**NONE, "fused_self_attention": 7, "fused_geglu_ff": 7,
                "cross_self_partials": 2, "streaming_self_attention": 1}
DIT_TRIPLET_CALL = {**NONE, "fused_self_attention": 13, "cross_self_partials": 4}
DIT_PAIRS_CALL = {**NONE, "fused_self_attention": 13, "cross_self_partials": 2}
# the tiny DiT at 128 px, tap block 1: K1 in block 0 and in the tiny VAE's mid attention
TINY_DIT_CALL = {**NONE, "fused_self_attention": 2, "cross_self_partials": 2}
TINY_DIT = dict(input_size=64, patch_size=2, hidden=144, depth=2, heads=2, num_classes=10)
# this slice's paths: the ipref preset, and each call's launches (an attn2 or OUTPUT tap runs
# its block's attn1 first: one K1 more than the canonical attn1 QKV tap)
IPREF = dict(prompt="The photo of a cat", target_block="up_blocks", target_layer=(5,),
             target_step=750, similarity="cosine", seed=2334)
SD15_IP_CALL = {**NONE, "fused_self_attention": 9, "fused_geglu_ff": 4}
XL_IP_PAIRS_CALL = {**NONE, "fused_self_attention": 46, "fused_geglu_ff": 4,
                    "streaming_self_attention": 2}
TINY_SD15_IP_CALL = {**NONE, "fused_self_attention": 4, "fused_geglu_ff": 3}
# the tiny SD-1.5 at 64 px: K1 in down block 0, the mid block, up block 1 and the VAE's mid
TINY_SD15_K3_CALL = {**NONE, "fused_self_attention": 4, "fused_geglu_ff": 3,
                     "cross_self_partials": 2}
TINY_XL_IP_CALL = {**TINY_XL_CALL, "fused_self_attention": 8, "cross_self_partials": 0}


START = time.perf_counter()  # each phase header gives the seconds since the script started


def phase(name: str) -> None:
    print(f"== [{time.perf_counter() - START:.1f} s] {name}", flush=True)
    # the card's state as the phase starts: a card held at its power limit lowers its clock
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu,"
                          "clocks_throttle_reasons.active", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"  card: SM clock, power, temperature, throttle reasons = {smi.stdout.strip()}",
          flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of ``fn`` in ms over ``reps`` runs, each between two CUDA events: host work
    enters whenever the host takes longer per call than the device."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


# How device times are taken, fixed by :func:`probe_timing` before the first one: "cupti", the
# kernel durations torch.profiler records; or "cuda_events", two CUDA events around back-to-back
# calls, where torch.profiler cannot be used (another profiler already runs in this process, or
# it cannot start) or records no kernel. Once it records nothing, it is not started again.
TIMING = {"method": "cupti"}


def _other_profiler() -> bool:
    """Whether a torch.profiler or autograd profiler session already records in this process."""
    return torch.autograd._profiler_enabled() or torch.autograd.profiler._is_profiler_enabled


def _kernel_records(fn, reps: int) -> tuple[list[tuple[str, int, float]], float]:
    """(name, launches, ms) of each kernel ``fn`` launched over ``reps`` back-to-back calls, from
    torch.profiler's CUPTI records, and the calls' wall time in ms under the profiler; no records
    if it recorded none or could not start."""
    from torch.profiler import ProfilerActivity, profile

    if _other_profiler():  # a second session would stop the other one's trace with its own
        print("  torch.profiler not started: another profiler runs in this process", flush=True)
        return [], 0.0
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as err:  # another session holds the process's profiler
        print(f"  torch.profiler could not start: {err}", flush=True)
        return [], 0.0
    try:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        prof.stop()
    # kernel entries only: an aten op's own entry repeats the device time of its kernels
    return [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0], wall_ms


def _profiled_kernels(fn, reps: int) -> dict[str, float]:
    """ms per call of each kernel ``fn`` launched over ``reps`` back-to-back calls (CUPTI)."""
    by_name: dict[str, float] = {}
    for name, _, ms in _kernel_records(fn, reps)[0]:
        by_name[name] = by_name.get(name, 0.0) + ms / reps
    return by_name


def probe_timing() -> str:
    """Choose how device times are taken in this run (``TIMING``) and say why."""
    if _other_profiler():
        TIMING["method"] = "cuda_events"
        why = "a profiler already runs in this process"
    else:
        a = torch.ones(1024, 1024, device="cuda")
        for _ in range(2):
            if _profiled_kernels(lambda: a @ a, 3):
                TIMING["method"], why = "cupti", "torch.profiler records the card's kernels"
                break
        else:
            TIMING["method"] = "cuda_events"
            why = "torch.profiler recorded no kernel of a probe matmul, twice"
    print(f"  device times by {TIMING['method']}: {why}", flush=True)
    return TIMING["method"]


def device_ms(fn, reps: int = 20, warmup: int = 3) -> tuple[float, dict[str, float]]:
    """Device time of one call of ``fn`` in ms over ``reps`` back-to-back calls, and the same
    per kernel name. By CUPTI (``TIMING``), host work cannot enter: the durations of the kernels
    it launched, summed and divided by ``reps``. By CUDA events (the per-kernel split is then
    empty), the time between an event before the first call and one after the last, divided by
    ``reps``: the queue of launches keeps the card busy unless the host takes longer per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if TIMING["method"] == "cupti":
        for _ in range(2):  # a session that records no kernel at all is taken again once
            by_name = _profiled_kernels(fn, reps)
            if by_name:
                return sum(by_name.values()), by_name
        TIMING["method"] = "cuda_events"
        print("  torch.profiler recorded no kernel twice: device times by cuda_events from here "
              "on", flush=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, {}


def bound(flops: float, nbytes: float, dtype=torch.bfloat16, exps: float = 0.0,
          tf32_passes: float = 0.0) -> tuple[float, str, dict]:
    """The least time the card could take for the work, in ms: the largest of the products
    over their peak (for a kernel that splits float32 operands into TF32 parts, the FLOP times
    ``tf32_passes``, the TF32 products per float32 product averaged over its products, over the
    TF32 peak), the exponentials over the special-function units' rate and the bytes over the
    memory rate. Products and exponentials are both "operations"."""
    t_ops = (tf32_passes * flops / PEAK_TF32 if tf32_passes else flops / PEAK_FLOPS[dtype]) * 1e3
    terms = {"ops_ms": t_ops, "exp_ms": exps / PEAK_EXP * 1e3,
             "bytes_ms": nbytes / PEAK_BYTES * 1e3}
    t = max(terms.values())
    return t, "bytes" if t == terms["bytes_ms"] else "operations", terms


def check_close(name, out, ref, atol, rtol, quiet: bool = False) -> float:
    err = (out.float() - ref.float()).abs().max().item()
    ok = torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol)
    if not quiet or not ok:
        print(f"  {name}: max|kernel - plain| = {err:.3e} (atol {atol}, rtol {rtol}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok or not torch.isfinite(out).all():
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    return err


def check_score(name, out, ref, similarity, atol, rtol) -> float:
    """Hold a kernel's scores to its plain version's: within ``atol`` and within ``rtol`` times
    the plain version's distance (1 - cosine, or the mse), so that a near-miss of a score near
    1 cannot pass as a small absolute error."""
    err = (out - ref).abs().max().item()
    dist = (1.0 - ref if similarity == "cosine" else ref).abs()
    ok = err <= atol and bool(((out - ref).abs() <= rtol * dist).all())
    print(f"  {name}: scores {out.tolist()}, max|kernel - plain| = {err:.3e} (atol {atol}, "
          f"rtol {rtol} of the distance {dist.min().item():.3e}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok or not torch.isfinite(out).all():
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    return err


# The bf16_probs checks that tell the two modes apart. The plain versions follow XLA's CPU
# compiler (the JAX tests' reference), which sums unrounded exponentials, so a kernel held to
# them at bf16 tolerance could ignore the mode. These inputs make every logit exact in float32
# and put each row's largest logit at key 0, in the first key tile, so the kernels' running max
# is the whole row's from the first tile on; the reference then rounds exactly where the CUDA
# kernels do (attention_common.cuh prob_bf16, the rounded row sum), and nothing is left to
# differ but float32 summation order.
LOG2E = 1.4426950408889634
ULP_BF16 = 2.0**-7  # a bf16 ulp relative to the value, at most
PLANT_ROWS = 4096  # query rows per reference block


def planted_qkv(shape, dtype, gen):
    """q, k, v on a 1/8 grid (exact in bf16 and in TF32, so every logit and partial sum is
    exact in float32), with q[..., 0] = 1 and key 0's first component raised by the largest
    gap any row has to its own max, to an integer that ``dtype`` holds (bf16 holds only even
    ones past 256, a gap that wide heads reach): key 0 holds every row's largest logit."""
    q, k, v = ((torch.randn(shape, generator=gen, device=gen.device) * 8).round() / 8
               for _ in range(3))
    q[..., 0] = 1.0
    k[..., 0] = 0.0
    b, h, s, d = shape
    qf, kf = q.reshape(b * h, s, d).double(), k.reshape(b * h, s, d).double()
    gap = 0.0
    for i in range(b * h):
        for r0 in range(0, s, PLANT_ROWS):
            logits = qf[i, r0:r0 + PLANT_ROWS] @ kf[i].T
            gap = max(gap, (logits.amax(-1) - logits[:, 0]).max().item())
    plant = float(np.ceil(gap))
    while torch.tensor(plant).to(dtype).item() < gap:  # the cast would round it down
        plant += 1.0
    k[:, :, 0, 0] = plant
    return q.to(dtype), k.to(dtype), v.to(dtype)


def mode_probs(centred: torch.Tensor, scale_bf16: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16_probs mode's probabilities of float32 centred logits s - m as the CUDA kernels
    take them (attention_common.cuh prob_bf16x2): s - m rounded to bf16, its product with the
    bf16 scale rounded to bf16, exp2 of that times log2 e in float32 (``p32``), and ``p32``
    rounded to bf16 (``p``)."""
    p32 = torch.exp2(round_bf16(round_bf16(centred) * scale_bf16) * LOG2E)
    return p32, round_bf16(p32)


def rounded_probs_reference(q, k, v, sum_tile: int | None = None, tc_steps: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16_probs mode as the CUDA kernels round it, on :func:`planted_qkv` inputs, in
    float64: p from :func:`mode_probs` (bf16(exp2(bf16(bf16(s - m) * bf16(scale)) * log2 e))
    with exp2 in float32 as the kernels take it), and out = (P V) / l. K1 (``sum_tile`` None) rounds the row sum l of the
    rounded p to bf16 once; K4 rounds the sum of each of its ``sum_tile``-key tiles to bf16 and
    adds those in float32, leaving l unrounded. Also returns, per element, what roundings the
    kernel may take the other way contribute at most: a probability within 8 float32 ulp of a
    bf16 rounding midpoint (exp2 implementations differ by ulps), and a sum within 2^-13 (a
    row's) or 2^-16 (a tile's) of one (the kernels sum in float32, in their own order), each
    moving its term by a bf16 ulp; and ``tc_steps`` steps of a P V sum in the tensor cores'
    float32, which truncates, each losing up to an ulp (2^-23) of the running sum."""
    b, h, s, d = q.shape
    scale_bf16 = round_bf16(torch.tensor(d ** -0.5)).item()
    qf, kf, vf = (t.reshape(b * h, s, d) for t in (q, k, v))
    out = torch.empty((b * h, s, d), dtype=torch.float64, device=q.device)
    allow = torch.empty_like(out)

    def flips(x, delta):  # x's bf16 rounding could go the other way under a relative error
        return round_bf16((x * (1 - delta)).float()) != round_bf16((x * (1 + delta)).float())

    for i in range(b * h):
        vd = vf[i].double()
        for r0 in range(0, s, PLANT_ROWS):
            logits = (qf[i, r0:r0 + PLANT_ROWS].double() @ kf[i].double().T).float()
            m = logits.amax(-1, keepdim=True)
            if not torch.equal(m, logits[:, :1]):
                raise SystemExit("planted_qkv: a row's largest logit is not at key 0")
            p32, p = mode_probs(logits - m, scale_bf16)
            del logits
            amb = flips(p32, 2.0**-21)
            del p32
            pd = p.double()
            if sum_tile is None:
                l64 = pd.sum(-1, keepdim=True)
                l = round_bf16(l64.float()).double()
                l_amb = flips(l64, 2.0**-13) * l
            else:
                tiles = pd.reshape(pd.shape[0], -1, sum_tile).sum(-1)
                l = round_bf16(tiles.float()).double().sum(-1, keepdim=True)
                l_amb = (flips(tiles, 2.0**-16) * tiles).sum(-1, keepdim=True)
            o = (pd @ vd) / l
            out[i, r0:r0 + PLANT_ROWS] = o
            allow[i, r0:r0 + PLANT_ROWS] = ULP_BF16 * (
                ((amb * pd) @ vd.abs()) / l + (l_amb / l) * o.abs())
            if tc_steps:
                allow[i, r0:r0 + PLANT_ROWS] += tc_steps * 2.0**-23 * (pd @ vd.abs()) / l
    return out.reshape(q.shape), allow.reshape(q.shape)


def disagreement(out, ref) -> float:
    """How far a kernel's output is from the rounded reference, in a measure that its own
    output rounding does not drown: in bf16, the share of elements that differ from the
    reference rounded to bf16; in float32, the mean error over the mean magnitude."""
    if out.dtype == torch.bfloat16:
        return (out != ref.to(torch.bfloat16)).double().mean().item()
    return ((out.double() - ref).abs().mean() / ref.abs().mean()).item()


def check_rounding(name, kernel, shape, dtype, gen, sum_tile: int | None = None,
                   tc_steps: int | None = None) -> dict:
    """Hold a kernel's bf16_probs mode to :func:`rounded_probs_reference` elementwise (float32:
    within 1e-5 + 1e-5 |ref|; bf16: within half a bf16 ulp, 2^-8 |ref|, + 1e-5; both plus the
    flippable roundings' allowance and ``tc_steps`` truncating tensor-core steps of the P V sum:
    by default S/16 k16 steps for bf16 kernels and none for float32), and require its
    disagreement with the reference to be at most a tenth of the exact mode's on the same
    inputs. The mean signed error over the mean magnitude, towards zero negative, is printed as
    information (the tensor cores' truncation shows there)."""
    q, k, v = planted_qkv(shape, dtype, gen)
    if tc_steps is None:
        tc_steps = shape[2] // 16 if dtype == torch.bfloat16 else 0
    ref, allow = rounded_probs_reference(q, k, v, sum_tile, tc_steps)
    fast = kernel(q, k, v, True).double()
    exact = kernel(q, k, v, False).double()
    rel = 2.0**-8 if dtype == torch.bfloat16 else 1e-5
    lim = 1e-5 + rel * ref.abs() + allow
    err_fast, err_exact = (fast - ref).abs(), (exact - ref).abs()
    over = (err_fast - lim).max().item()
    dis_fast = disagreement(fast.to(dtype), ref)
    dis_exact = disagreement(exact.to(dtype), ref)
    res = {"max_err": err_fast.max().item(), "exact_max_err": err_exact.max().item(),
           "disagreement": dis_fast, "exact_disagreement": dis_exact,
           "bias": (((fast - ref) * ref.sign()).mean() / ref.abs().mean()).item(),
           "flippable_share": (allow > 0).double().mean().item(),
           "exact_within_limit": bool((err_exact <= lim).all())}
    ok = over <= 0 and dis_fast <= 0.1 * dis_exact
    print(f"  {name} vs the kernels' rounding (planted max, exact logits): max err "
          f"{res['max_err']:.3e} (exact mode {res['exact_max_err']:.3e}; limit "
          f"1e-5 + {rel:g}|ref| + allowance, on {res['flippable_share']:.2e} of elements), "
          f"bias {res['bias']:.2e}, disagreement {dis_fast:.3e} against the exact mode's {dis_exact:.3e} (limit a "
          f"tenth) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok or not torch.isfinite(fast).all():
        raise SystemExit(f"{name}: the bf16_probs kernel does not round as the mode does")
    return res


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0 = {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    return line


def _timed(row, kernel, plain, flops, nbytes, *, library=None, v2=None, info=None,
           kernel_name=None, call=None, dtype=torch.bfloat16, plain_reps=20, exps: float = 0.0,
           tf32_passes: float = 0.0):
    """Time the kernel, its library call, its previous design (``v2``) and the ``info``
    yardsticks ({key: fn}) in turns, twice over, as device time (:func:`device_ms`), and keep
    each one's lower reading. ``kernel_name`` (a substring of the kernel's name) keeps only the
    kernel's own launches in ``ms``; ``call`` is the whole wrapper call (default: ``kernel``),
    timed with CUDA events as ``call_ms`` and, where it launches more than the kernel, on the
    device as ``call_device_ms``."""
    timed = {"ms": kernel, "library_ms": library, "v2_ms": v2, **(info or {})}
    timed = {key: fn for key, fn in timed.items() if fn is not None}
    best, kernels_of, methods = {}, {}, set()
    for _ in range(2):
        for key, fn in timed.items():
            ms, by_name = device_ms(fn)
            methods.add("cupti" if by_name else "cuda_events")
            if key == "ms" and kernel_name is not None and by_name:
                ms = sum(t for name, t in by_name.items() if kernel_name in name)
                if ms == 0.0:
                    raise SystemExit(f"no kernel named like {kernel_name!r} in {sorted(by_name)}")
            if key not in best or ms < best[key]:
                best[key], kernels_of[key] = ms, by_name
    row.update(best)
    row.setdefault("library_ms", None)
    # by CUDA events, ``ms`` is the whole ``kernel`` call, its other launches included
    row["timing"] = "+".join(sorted(methods))
    call = kernel if call is None else call
    row["call_ms"] = time_ms(call)
    if kernel_name is not None:
        row["call_device_ms"] = device_ms(call)[0]
    row["plain_ms"] = time_ms(plain, reps=plain_reps)
    row["bound_ms"], row["bound_by"], row["bound_terms"] = bound(flops, nbytes, dtype, exps,
                                                                 tf32_passes)
    ops = (f"495 TFLOP/s TF32 tensor, {tf32_passes:g} passes (3xTF32)" if tf32_passes
           else "989 TFLOP/s bf16 tensor" if dtype == torch.bfloat16
           else "67 TFLOP/s FP32 non-tensor")
    row["peak"] = f"{ops} | {PEAK_EXP:.1e} exp/s | 3.35 TB/s"
    lib = "none" if library is None else f"{row['library_ms']:.4f}"
    extra = "".join(f"  {key[:-3]} {row[key]:.4f}" for key in timed if key not in
                    ("ms", "library_ms"))
    dev = f" (device {row['call_device_ms']:.4f})" if "call_device_ms" in row else ""
    terms = ", ".join(f"{k[:-3]} {v:.4f}" for k, v in row["bound_terms"].items())
    print(f"    ms {row['ms']:.4f}{extra}  library {lib}  call {row['call_ms']:.4f}{dev}  plain "
          f"{row['plain_ms']:.4f}  bound {row['bound_ms']:.4f} ({row['bound_by']}: {terms})",
          flush=True)
    # which kernels each call ran, by device time: the kernel's own split (K2's two GEMMs) and
    # the yardsticks' (SDPA's backend)
    for key, by_name in kernels_of.items():
        if key != "v2_ms" and (key != "ms" or len(by_name) > 1):
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
            print(f"    {key[:-3]} kernels: " + "; ".join(f"{t:.4f} {name[:90]}" for name, t in top),
                  flush=True)


# the previous designs timed beside the shipped kernels: {entry: (library, ctypes argument
# types)}; chip_smoke.py is their only caller, and they count no launches
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
YARDSTICKS = {
    "fused_attention_v2_fwd": ("attention_v2", [_P] * 4 + [_I] * 3 + [_F, _P]),
    "fused_attention_f32_v1_fwd": ("attention_v2", [_P] * 4 + [_I] * 3 + [_F, _I, _P]),
    "streaming_attention_v2_fwd": ("attention_v2", [_P] * 4 + [_I] * 3 + [_F, _P]),
    "streaming_attention_bf16_v2_fwd": ("attention_v2", [_P] * 4 + [_I] * 3 + [_F, _I, _P]),
    "geglu_ff_v2_fwd": ("geglu_ff_v2", [_P] * 7 + [_I, _I, _P]),
    "geglu_ff_f32_v1_fwd": ("geglu_ff_v2", [_P] * 7 + [_I, _I, _P]),
    "fused_readout_v2_fwd": ("fused_readout_v2", [_P] * 6 + [_I] * 3 + [_F, _I, _P]),
    "fused_readout_f32_v1_fwd": ("fused_readout_v2", [_P] * 6 + [_I] * 3 + [_F, _I, _P]),
    "streaming_attention_wide_v1_fwd": ("streaming_attention_wide_v1",
                                        [_P] * 4 + [_I] * 3 + [_F, _I, _I, _P]),
    "fused_attention_bwd_v1": ("fused_attention_bwd_v1", [_P] * 8 + [_I] * 3 + [_F, _I, _P]),
}


def _yardstick(name: str, *args) -> None:
    lib_name, argtypes = YARDSTICKS[name]
    lib = build.library(lib_name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    build.check(lib, fn(*args, torch.cuda.current_stream().cuda_stream), name)


def v2_kernel(name: str, q, k, v, *mode):
    """The previous design of K1 (bf16) or K4 (float32, or bf16 with its ``bf16_probs`` flag
    in ``mode``; the wide heads with their dtype code and that flag) on the same inputs."""
    b, h, s, d = q.shape
    out = torch.empty_like(v)
    _yardstick(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, s, d,
               float(d**-0.5), *mode)
    return out


def v2_f32_attention(q, k, v, tol, bf16_probs: bool = False):
    """The previous design of K1's float32 path (plain FMAs) on these inputs, held to the plain
    version within ``tol`` (atol, rtol) first; returns the call, the yardstick of the 3xTF32
    kernel's time."""
    b, h, s, d = q.shape

    def call():
        out = torch.empty_like(v)
        _yardstick("fused_attention_f32_v1_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   out.data_ptr(), b * h, s, d, float(d**-0.5), int(bf16_probs))
        return out

    mode = " bf16_probs" if bf16_probs else ""
    with torch.no_grad():
        check_close(f"K1 v2 (FMA){mode} {(b, h, s, d)} float32", call(),
                    fused_self_attention_plain(q, k, v, bf16_probs), *tol)
    return call


def v1_bwd(q, k, v, g, tol):
    """The first design of K1's backward (csrc/fused_attention_bwd_v1.cu) on these inputs, held
    to the plain version within ``tol`` (atol, rtol) first; returns the call, the yardstick of
    the shipped design's time."""
    b, h, s, d = q.shape

    def call():
        grads = [torch.empty_like(t) for t in (q, k, v)]
        stats = torch.empty(3 * b * h * s, dtype=torch.float32, device=q.device)
        _yardstick("fused_attention_bwd_v1", *(t.data_ptr() for t in (q, k, v, g, *grads)),
                   stats.data_ptr(), b * h, s, d, float(d**-0.5), kattn._DTYPES[q.dtype])
        return grads

    with torch.no_grad():
        ref = kattn.fused_self_attention_bwd_plain(q, k, v, g)
        for x, a, b_ in zip("qkv", call(), ref):
            check_close(f"K1 backward {tuple(q.shape)} first design d{x}", a, b_, *tol)
    return call


# the build's ptxas report of each compiled source (build.build), kept for the phases that print
# a kernel's registers and spills
PTXAS = {}


def ptxas_usage(source: str, like: str) -> list[str]:
    """Registers and spills of each kernel of ``source`` whose mangled name contains ``like``,
    from this run's build report (none if the source was built before this run)."""
    out, name = [], None
    for line in PTXAS.get(source, "").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and like in name and ("spill" in line or "Used" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def v2_geglu_ff(x, w1, b1, w2, b2):
    """The previous design of K2 on the same inputs: bf16's v2, or float32's first (FMA)."""
    n, c = x.shape
    y = torch.empty((n, 4 * c), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    name = "geglu_ff_f32_v1_fwd" if x.dtype == torch.float32 else "geglu_ff_v2_fwd"
    _yardstick(name, *(t.data_ptr() for t in (x, w1, b1, w2, b2, y, out)), n, c)
    return out


def readout_launch(name: str, q, k1, v1, k2, v2, mse: bool = False) -> torch.Tensor:
    """K3's previous design on (N, S, D) rows: the kernel alone, into the (N, S / 64, 3)
    partials buffer."""
    n, s, d = q.shape
    out = torch.empty((n, s // 64, 3), dtype=torch.float32, device=q.device)
    _yardstick(name, *(t.data_ptr() for t in (q, k1, v1, k2, v2, out)), n, s, d,
               float(d**-0.5), int(mse))
    return out


def readout_partials(name: str):
    """``cross_self_partials`` through :func:`readout_launch`."""
    def partials(*rows, mse=False):
        sums = readout_launch(name, *rows, mse=mse).sum(dim=1)
        return sums[:, 0], sums[:, 1], sums[:, 2]
    return partials


def _cublas_geglu_ff(x, w1, b1, w2, b2):
    """The same function as cuBLAS's two projections with PyTorch's elementwise GEGLU between
    them (an information yardstick; the port never calls it)."""
    h, g = F.linear(x, w1, b1).chunk(2, dim=-1)
    return F.linear(h * F.gelu(g), w2, b2)


def k1_phase(gen) -> dict:
    phase("K1 fused_self_attention vs plain (bf16 atol=rtol=1e-2, float32 atol=1e-5)")
    shapes = [(*site, torch.bfloat16) for site in K1_SITES]
    shapes += [(2, 8, 1280, 64, torch.bfloat16), (2, 8, 1024, 80, torch.float32)]
    rows, main_err = [], 0.0
    for b, h, s, d, dtype in shapes:
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        out = fused_self_attention(q, k, v)
        torch.cuda.synchronize()
        ref = fused_self_attention_plain(q, k, v)
        tol = (1e-2, 1e-2) if dtype == torch.bfloat16 else (1e-5, 0.0)
        err = check_close(f"K1 {(b, h, s, d)} {dtype}", out, ref, *tol)
        del out
        row = {"shape": [b, h, s, d], "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": err}
        if (b, h, s, d) in K1_SITES:
            main_err = max(main_err, err)
            (row["launches_sd15_forward"], row["launches_sdxl_call"],
             row["launches_dit_call"]) = K1_SITES[(b, h, s, d)]
            v2 = lambda: v2_kernel("fused_attention_v2_fwd", q, k, v)  # noqa: E731
            check_close(f"K1 v2 {(b, h, s, d)}", v2(), ref, *tol, quiet=True)
            _timed(row, lambda: fused_self_attention(q, k, v),
                   lambda: fused_self_attention_plain(q, k, v),
                   4 * b * h * s * s * d, 4 * b * h * s * d * q.element_size(),
                   library=lambda: F.scaled_dot_product_attention(q, k, v), v2=v2,
                   exps=b * h * s * s)
        elif dtype == torch.float32:  # the 3xTF32 design beside the FMA one it replaced
            _timed(row, lambda: fused_self_attention(q, k, v),
                   lambda: fused_self_attention_plain(q, k, v),
                   4 * b * h * s * s * d, 4 * b * h * s * d * q.element_size(),
                   library=lambda: F.scaled_dot_product_attention(q, k, v),
                   v2=v2_f32_attention(q, k, v, tol), dtype=dtype, exps=b * h * s * s,
                   tf32_passes=3.0)
        rows.append(row)
        del q, k, v, ref
        torch.cuda.empty_cache()
    # every head dim the kernel takes (D % 8 == 0, D <= 160: ten padded bf16 widths, twenty
    # float32 instantiations), two S
    for dtype, tol in ((torch.bfloat16, (1e-2, 1e-2)), (torch.float32, (1e-5, 0.0))):
        errs = []
        for d in range(8, 161, 8):
            for s in (64, 192):
                q, k, v = (torch.randn((2, 3, s, d), generator=gen, device="cuda").to(dtype)
                           for _ in range(3))
                errs.append(check_close(f"K1 {(2, 3, s, d)} {dtype}",
                                        fused_self_attention(q, k, v),
                                        fused_self_attention_plain(q, k, v), *tol, quiet=True))
        print(f"  K1 at every D in 8..160 step 8, S in (64, 192), {dtype}: max|kernel - plain| "
              f"= {max(errs):.3e} (atol {tol[0]}) ok", flush=True)
    return {"rows": rows, "max_abs_err": main_err}


def k2_phase(gen) -> dict:
    phase("K2 fused_geglu_ff vs plain (bf16 atol=rtol=1e-2, float32 atol=rtol=1e-4)")
    rows, f32_rows, main_err, f32_err = [], [], 0.0, 0.0

    def rand(shape, scale, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    # the main-path sites in bf16 beside v2, then in float32 (3xTF32) beside the first (FMA)
    # design and cuBLAS's float32 path with TF32 off (the float32 contract)
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        f32 = dtype == torch.float32
        for (n, c), launches in K2_SITES.items():
            x = rand((n, c), 1.0, dtype)
            w1, b1 = rand((8 * c, c), c**-0.5, dtype), rand((8 * c,), 0.1, dtype)
            w2, b2 = rand((c, 4 * c), (4 * c) ** -0.5, dtype), rand((c,), 0.1, dtype)
            args = (x, w1, b1, w2, b2)
            out = fused_geglu_ff(*args)
            torch.cuda.synchronize()
            ref = fused_geglu_ff_plain(*args)
            err = check_close(f"K2 {(n, c)} {dtype}", out, ref, tol, tol)
            check_close(f"K2 {'v1 (FMA)' if f32 else 'v2'} {(n, c)}", v2_geglu_ff(*args),
                        ref if f32 else out, tol, tol, quiet=True)
            del out, ref
            key = "_f32" if f32 else ""
            row = {"shape": [n, c], "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
                   f"launches_sd15{key}_forward": launches[0],
                   f"launches_sdxl{key}_call": launches[1]}
            with tf32_off() if f32 else contextlib.nullcontext():
                _timed(row, lambda: fused_geglu_ff(*args), lambda: fused_geglu_ff_plain(*args),
                       24 * n * c * c, (2 * n * c + 12 * c * c + 9 * c) * x.element_size(),
                       v2=lambda: v2_geglu_ff(*args),
                       info={"cublas_path_ms": lambda: _cublas_geglu_ff(*args)}, dtype=dtype,
                       tf32_passes=3.0 if f32 else 0.0)
            (f32_rows if f32 else rows).append(row)
            if f32:
                f32_err = max(f32_err, err)
            else:
                main_err = max(main_err, err)
            del x, w1, b1, w2, b2, args
            torch.cuda.empty_cache()
    # ragged row counts and other widths, both dtypes (float32 at atol = rtol = 1e-4)
    for n, c in [(8, 32), (300, 32), (1000, 64), (136, 160), (24 * 256, 1280)]:
        for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
            args = (rand((n, c), 1.0, dtype), rand((8 * c, c), c**-0.5, dtype),
                    rand((8 * c,), 0.1, dtype), rand((c, 4 * c), (4 * c) ** -0.5, dtype),
                    rand((c,), 0.1, dtype))
            check_close(f"K2 {(n, c)} {dtype}", fused_geglu_ff(*args),
                        fused_geglu_ff_plain(*args), tol, tol)
    return {"rows": rows, "max_abs_err": main_err,
            "f32": {"rows": f32_rows, "max_abs_err": f32_err}}


def _sdpa_readout(taps, similarity):
    """The same scores from two library attention calls per direction plus the reductions
    (information for PERF.md; the port never calls this). The taps go in 4-D, (P*B, H, S, D):
    SDPA's flash backend takes only 4-D inputs, and bf16 taps are held to it."""
    qa, ka, va, kb, vb = (t.flatten(0, 1) for t in taps)
    backend = (SDPBackend.FLASH_ATTENTION if qa.dtype == torch.bfloat16
               else SDPBackend.EFFICIENT_ATTENTION)
    with sdpa_kernel(backend):
        o1 = F.scaled_dot_product_attention(qa, kb, vb).float()
        o2 = F.scaled_dot_product_attention(qa, ka, va).float()
    if similarity == "mse":
        return ((o1 - o2) ** 2).sum()
    return (o1 * o2).sum() / ((o1 * o1).sum().sqrt() * (o2 * o2).sum().sqrt())


# K3's float32 rows: (P, B, H, S, D) taps of the float32 scoring calls (f32_scoring_phase), with
# the row key of each call's launches: the DiT-XL/2 tap of 8 triplets, the SDXL tap of 2 and the
# SD-1.5 up-block-2 tap of 4
K3_F32 = {(DIT_T, 2, 16, 1024, 72): "launches_dit_f32_call",
          (XL_T, 2, 20, 1024, 64): "launches_sdxl_f32_call",
          (4, 2, 8, 1024, 80): "launches_sd15_k3_f32_call"}


def k3_phase(gen) -> dict:
    phase("K3 cross_self_partials (fused readout) vs plain: scores, bf16 atol 1e-3 and rtol 1e-3 "
          "of the distance, float32 atol 1e-5 and rtol 1e-5")
    # the previous designs: bf16's v2, float32's first (FMA)
    v2_name = {torch.bfloat16: "fused_readout_v2_fwd", torch.float32: "fused_readout_f32_v1_fwd"}
    v2_score = {dtype: functools.partial(readout._direction_score, readout_partials(name))
                for dtype, name in v2_name.items()}
    # (P, B, H, S, D): the SDXL tap of the main path (N = 80), the SD-1.5 up-block-2/3 taps of
    # a 2-pair score_batch, the DiT-XL/2 tap of its main path (head dim 72, N = 256), and in
    # float32 the taps of the float32 scoring calls
    shapes = [((XL_T, 2, 20, 1024, 64), torch.bfloat16), ((2, 2, 8, 1024, 80), torch.bfloat16),
              ((2, 2, 8, 4096, 40), torch.bfloat16), ((DIT_T, 2, 16, 1024, 72), torch.bfloat16),
              *((shape, torch.float32) for shape in K3_F32)]
    rows, f32_rows, main_err, f32_err = [], [], 0.0, 0.0
    for shape, dtype in shapes:
        # image B's keys and values are image A's plus noise, so that the scores sit where
        # DiffSim's do (cosine ~0.9): a kernel that pairs the wrong head or the wrong K/V
        # gives unrelated outputs and a cosine near 0
        qa, ka, va = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
        kb, vb = (x + 0.3 * torch.randn(shape, generator=gen, device="cuda") for x in (ka, va))
        taps = [x.to(dtype) for x in (qa, ka, va, kb, vb)]
        del qa, ka, va, kb, vb
        p, b, h, s, d = shape
        n = p * b * h
        bf16 = dtype == torch.bfloat16
        main = (n, s, d) == K3_MAIN and bf16
        dit_main = (n, s, d) == K3_DIT and bf16
        for similarity in ("cosine", "mse"):
            out = fused_direction_score(*taps, similarity)
            torch.cuda.synchronize()
            ref = fused_direction_score_plain(*taps, similarity)
            tol = 1e-3 if bf16 else 1e-5
            err = check_score(f"K3 {shape} {dtype} {similarity}", out, ref, similarity, tol, tol)
            row = {"shape": [n, s, d], "taps": list(shape), "similarity": similarity,
                   "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err}
            if main:
                main_err = max(main_err, err)
                row["launches_sdxl_call"] = 4 if similarity == "cosine" else 0
            if dit_main:
                row["launches_dit_call"] = 4 if similarity == "cosine" else 0
            if not bf16:
                f32_err = max(f32_err, err)
                row[K3_F32[shape]] = 4 if similarity == "cosine" else 0
            check_score(f"K3 {'v2' if bf16 else 'v1 (FMA)'} {shape} {similarity}",
                        v2_score[dtype](*taps, similarity), ref, similarity, tol, tol)
            if similarity == "cosine" and (main or dit_main or not bf16 or d == 80):
                flat = [x.reshape(n, s, d) for x in (taps[0], taps[3], taps[4], taps[1], taps[2])]
                info = {"sdpa_pair_ms": lambda: _sdpa_readout(taps, similarity)}
                _timed(row, lambda: cross_self_partials(*flat),
                       lambda: fused_direction_score_plain(*taps, similarity),
                       8 * n * s * s * d, 5 * n * s * d * taps[0].element_size(),
                       v2=lambda: readout_launch(v2_name[dtype], *flat), info=info,
                       kernel_name="readout_",
                       call=lambda: fused_direction_score(*taps, similarity), dtype=dtype,
                       plain_reps=5, exps=2 * n * s * s,
                       tf32_passes=0.0 if bf16 else 3.0)
                if row["timing"] == "cupti":  # by CUDA events, the call's host work enters
                    row["epilogue_ms"] = row["call_device_ms"] - row["ms"]
            (rows if bf16 else f32_rows).append(row)
        del taps
        torch.cuda.empty_cache()
    # float32 at every head dim the kernel takes (D % 8 == 0, D <= 128: one instantiation each),
    # two S
    errs = []
    for d in range(8, 129, 8):
        for s in (64, 192):
            qa, ka, va = (torch.randn((1, 2, 2, s, d), generator=gen, device="cuda")
                          for _ in range(3))
            taps = (qa, ka, va, ka + 0.3 * torch.randn_like(ka), va + 0.3 * torch.randn_like(va))
            for similarity in ("cosine", "mse"):
                out = fused_direction_score(*taps, similarity)
                ref = fused_direction_score_plain(*taps, similarity)
                errs.append((out - ref).abs().max().item())
                dist = (1.0 - ref if similarity == "cosine" else ref).abs()
                if not ((out - ref).abs() <= torch.clamp(1e-5 * dist, max=1e-5)).all():
                    raise SystemExit(f"K3 {(1, 2, 2, s, d)} float32 {similarity}: {out.tolist()} "
                                     f"against the plain version's {ref.tolist()}")
    print(f"  K3 at every D in 8..128 step 8, S in (64, 192), float32, cosine and mse: "
          f"max|kernel - plain| = {max(errs):.3e} (atol 1e-5, rtol 1e-5 of the distance) ok",
          flush=True)
    return {"rows": rows, "max_abs_err": main_err,
            "f32": {"rows": f32_rows, "max_abs_err": f32_err}}


K4_BF16_SWEEP = (168, 256, 384, 504, 512)  # head dims of the bf16 sweep at S = 8192
# bf16 on N(0, 1) inputs: at S >= 8192 the outputs are means over thousands of keys, |out| of
# about 1e-2, and the kernel and the plain version differ by a bf16 ulp of the largest ones
# (4.883e-4 on an H100); the limit is about four of those
K4_BF16_TOL = (2e-3, 1e-2)
# bf16 on sharp logits (q scaled by K4_SHARP_Q: logits N(0, 16), each row led by a few keys), so
# that the outputs are O(1) and a lost key slice moves them by O(1): within atol = rtol = 1e-2.
# Its control, the plain version with keys K4_DROP (the second consumer's slice of the first
# tile) left out, must exceed that limit.
K4_SHARP_Q = 4.0
K4_SHARP_TOL = (1e-2, 1e-2)
K4_DROP = (32, 64)


def k4_sharp_check(shape, gen) -> dict:
    """K4's bf16 exact mode on sharp logits against the plain version, and the control that a
    kernel dropping one 32-key slice of P V would give, which must fail the same limit."""
    q = (torch.randn(shape, generator=gen, device="cuda") * K4_SHARP_Q).to(torch.bfloat16)
    k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
    out = streaming_self_attention(q, k, v)
    torch.cuda.synchronize()
    ref = streaming_self_attention_plain(q, k, v)
    err = check_close(f"K4 {shape} bf16, sharp logits", out, ref, *K4_SHARP_TOL)
    keep = torch.cat([torch.arange(K4_DROP[0]), torch.arange(K4_DROP[1], shape[2])]).cuda()
    kd, vd = k[:, :, keep], v[:, :, keep]
    ctl = torch.cat([fused_self_attention_plain(q[:, :, i:i + 2048], kd, vd).float()
                     for i in range(0, shape[2], 2048)], dim=2)
    del kd, vd
    ref = ref.float()
    lim = K4_SHARP_TOL[0] + K4_SHARP_TOL[1] * ref.abs()
    share, ctl_share = (((x.float() - ref).abs() / lim).max().item() for x in (out, ctl))
    ctl_err = (ctl - ref).abs().max().item()
    print(f"  largest |kernel - plain| / limit {share:.3f}; control, keys [{K4_DROP[0]}, "
          f"{K4_DROP[1]}) left out: max|control - plain| = {ctl_err:.3e}, / limit {ctl_share:.3f} "
          f"({'fails the limit: ok' if ctl_share > 1 else 'within the limit: FAIL'}); mean "
          f"|plain| {ref.abs().mean().item():.3e}", flush=True)
    if not ctl_share > 1:
        raise SystemExit(f"K4 {shape} bf16, sharp logits: the control passes the limit")
    return {"shape": list(shape), "max_abs_err": err, "limit_share": share,
            "control_max_abs_err": ctl_err, "control_limit_share": ctl_share}


def k4_phase(gen) -> dict:
    phase(f"K4 streaming_self_attention vs plain (float32 atol 1e-5; bf16 atol {K4_BF16_TOL[0]}, "
          f"rtol {K4_BF16_TOL[1]}, and atol=rtol=1e-2 on sharp logits with a control that must "
          "fail it); bf16 timed beside its first design, which is held to the plain version too")
    shapes = [(K4_MAIN, torch.float32), (K4_MAIN, torch.bfloat16),
              (K4_XL_BF16[0], torch.bfloat16), ((1, 1, 8448, 512), torch.float32),
              ((1, 1, 8448, 512), torch.bfloat16), (K4_768, torch.bfloat16)]
    rows, main_err, bf16_err = [], 0.0, 0.0
    for shape, dtype in shapes:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
        out = streaming_self_attention(q, k, v)
        torch.cuda.synchronize()
        ref = streaming_self_attention_plain(q, k, v)
        tol = (1e-5, 0.0) if dtype == torch.float32 else K4_BF16_TOL
        err = check_close(f"K4 {shape} {dtype}", out, ref, *tol)
        del out
        row = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": err}
        b, h, s, d = shape
        v2 = None
        if dtype == torch.float32 and shape == K4_MAIN:
            main_err = err
            row["launches_sdxl_call"] = 3
            v2 = lambda: v2_kernel("streaming_attention_v2_fwd", q, k, v)  # noqa: E731
        elif dtype == torch.bfloat16:
            bf16_err = max(bf16_err, err)
            if shape in K4_XL_BF16:
                row["launches_sdxl_bf16_call"] = 1  # SDXL with --xl_vae_bf16
            if shape == K4_768:
                row["launches_sd15_768_pair"] = 1
            v2 = lambda: v2_kernel("streaming_attention_bf16_v2_fwd", q, k, v, 0)  # noqa: E731
        if v2 is not None:
            check_close(f"K4 v2 {shape} {dtype}", v2(), ref, *tol, quiet=True)
            _timed(row, lambda: streaming_self_attention(q, k, v),
                   lambda: streaming_self_attention_plain(q, k, v),
                   4 * b * h * s * s * d, 4 * b * h * s * d * q.element_size(),
                   library=lambda: F.scaled_dot_product_attention(q, k, v), v2=v2, dtype=dtype,
                   plain_reps=5, exps=b * h * s * s,
                   tf32_passes=3.0 if dtype == torch.float32 else 0.0)
        del ref
        rows.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    for d in K4_BF16_SWEEP:  # widths past 160 that the bf16 route admits, zero-filled to 512
        shape = (1, 1, 8192, d)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        out = streaming_self_attention(q, k, v)
        torch.cuda.synchronize()
        bf16_err = max(bf16_err, check_close(f"K4 {shape} bf16 (sweep)", out,
                                             streaming_self_attention_plain(q, k, v),
                                             *K4_BF16_TOL))
        del q, k, v, out
    sharp = [k4_sharp_check(shape, gen) for shape in (K4_MAIN, K4_768)]
    torch.cuda.empty_cache()
    return {"rows": rows, "max_abs_err": main_err, "bf16_max_abs_err": bf16_err, "sharp": sharp}


def _random_tree(factory, kind: str, rng, scale: float = 0.1) -> dict:
    """A seeded numpy parameter tree in the JAX package's layout for the module ``factory``
    builds: matrices N(0, scale^2), norm scales 1 + N(0, scale^2), biases N(0, scale^2 / 4)."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in factory().state_dict().items()}
    state = {}
    for name, shape in shapes.items():
        draw = rng.standard_normal(shape).astype(np.float32)
        if name.endswith("bias"):
            state[name] = draw * (scale / 2)
        elif len(shape) == 1:
            state[name] = 1.0 + draw * scale
        else:
            state[name] = draw * scale
    return bridge.to_jax_tree(state, kind)


@contextlib.contextmanager
def tf32_off():
    """Full float32 products and convolutions on the card, restored afterwards."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    print("  torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# card-vs-CPU limits on each score: |d| <= 1e-4 and |d| <= atol + 1e-4 * the distance (1 -
# cosine, or the mse), with atol near float32's resolution of the score
CARD_CPU_ATOL = {"cosine": 1e-6, "mse": 1e-7}


def _card_vs_cpu(name, make_scorer, pix_a, pix_b, noise, args, expected,
                 method: str = "score_batch") -> None:
    for similarity in ("cosine", "mse"):
        scores = {}
        for device in ("cuda", "cpu"):
            scorer = make_scorer(device)
            kernels.reset_launch_counts()
            scores[device] = getattr(scorer, method)(
                pix_a, pix_b, **{**args, "similarity": similarity}, noise_override=noise)
            counts = kernels.launch_counts()
            if device == "cuda":
                print(f"  launches on the card ({similarity}): {counts}")
                if counts != expected:
                    raise SystemExit(f"{name}: expected launches {expected}")
            del scorer
        gap = np.abs(scores["cuda"] - scores["cpu"])
        dist = np.abs(1.0 - scores["cpu"] if similarity == "cosine" else scores["cpu"])
        limit = np.minimum(1e-4, CARD_CPU_ATOL[similarity] + 1e-4 * dist)
        print(f"  {similarity}: card {scores['cuda']}, cpu {scores['cpu']}, "
              f"max|d| = {gap.max():.3e}, limits {limit}", flush=True)
        if not (np.isfinite(scores["cuda"]).all() and (gap <= limit).all()):
            raise SystemExit(f"{name}: the card disagrees with the CPU")


def tiny_phase() -> None:
    phase("end to end, tiny SD-1.5 at 32 px in float32: card vs CPU (|dscore| <= 1e-4 and "
          "<= atol + 1e-4 of the distance)")
    rng = np.random.default_rng(2334)
    cfgs = dict(unet_cfg=UNetConfig.tiny(), vae_cfg=VAEConfig.tiny(),
                text_cfg=CLIPTextConfig.tiny())
    params = {"unet": _random_tree(lambda: UNet(cfgs["unet_cfg"]), "unet", rng),
              "vae": _random_tree(lambda: Encoder(cfgs["vae_cfg"]), "vae", rng),
              "text": _random_tree(lambda: CLIPText(cfgs["text_cfg"]), "text", rng)}
    pix_a, pix_b = (rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8) for _ in range(2))
    noise = tuple(rng.standard_normal((2, 16, 16, 4)).astype(np.float32) for _ in range(2))
    with tf32_off():
        _card_vs_cpu("tiny SD-1.5", lambda device: DiffSimSD15(
            params, img_size=32, dtype=torch.float32, device=device,
            tokenizer=HashTokenizer(cfgs["text_cfg"].vocab_size), **cfgs),
            pix_a, pix_b, noise, CUTE, TINY_SD15_CALL)


def tiny_xl_phase() -> None:
    phase("end to end, tiny SDXL at 256 px in float32, one pair: card vs CPU (|dscore| <= 1e-4 "
          "and <= atol + 1e-4 of the distance; VAE mid 16384 tokens at D 256 -> K4, UNet 4096 tokens -> K1, C 64 -> K2, tap 4096 "
          "tokens at hd 32 -> K3)")
    rng = np.random.default_rng(2335)
    text2 = CLIPTextConfig(vocab_size=1000, hidden=32, layers=2, heads=2, intermediate=64,
                           act="gelu", projection_dim=16)
    cfgs = dict(unet_cfg=UNetConfig.tiny_xl(64), text_cfg=CLIPTextConfig.tiny(), text2_cfg=text2,
                vae_cfg=VAEConfig(block_out_channels=(32, 256), layers_per_block=1,
                                  scaling_factor=0.13025))
    params = {"unet": _random_tree(lambda: UNet(cfgs["unet_cfg"]), "unet", rng),
              "vae": _random_tree(lambda: Encoder(cfgs["vae_cfg"]), "vae", rng),
              "text": _random_tree(lambda: CLIPText(cfgs["text_cfg"]), "text", rng),
              "text2": _random_tree(lambda: CLIPText(text2), "text2", rng)}
    pix_a, pix_b = (rng.integers(0, 256, (1, 256, 256, 3), dtype=np.uint8) for _ in range(2))
    noise = tuple(rng.standard_normal((2, 128, 128, 4)).astype(np.float32) for _ in range(2))
    ip = _random_ip(cfgs["unet_cfg"], rng)

    def make_scorer(device, with_ip=False):
        scorer = DiffSimXL(params, img_size=256, dtype=torch.float32, device=device,
                           tokenizer=HashTokenizer(1000), **cfgs)
        if with_ip:
            scorer.enable_ip_adapter(**ip)
        return scorer

    with tf32_off():
        _card_vs_cpu("tiny SDXL", make_scorer, pix_a, pix_b, noise, XL_ARGS, TINY_XL_CALL)
        print("  with a tiny IP-Adapter-plus (the IP tap at attn2 of up (0, 1, 1); 256 -> 32 px "
              "for the tiny encoder):")
        _card_vs_cpu("tiny SDXL IP-Adapter", lambda device: make_scorer(device, True), pix_a,
                     pix_b, noise, {**XL_ARGS, "ip_adapter": True}, TINY_XL_IP_CALL)


def _random_ip(unet_cfg, rng) -> dict:
    """``enable_ip_adapter``'s arguments for a seeded tiny IP-Adapter-plus: the converted layout
    (a tiny Resampler of the UNet's cross dim, one adapter per attn2) and a tiny CLIP vision
    tree, drawn as :func:`_random_tree` draws."""
    rcfg = dataclasses.replace(ResamplerConfig.tiny(), output_dim=unet_cfg.cross_attention_dim)
    with torch.device("meta"):
        sites = [(a.to_k.in_features, a.to_q.out_features) for a in attn2_modules(UNet(unet_cfg))]
    converted = {
        "image_proj": _random_tree(lambda: Resampler(rcfg), "ip_proj", rng),
        "ip_weights": [[_random_tree(lambda: IPProjection(c, d), "unet", rng)] for c, d in sites],
        "plus": True}
    return dict(converted=converted, resampler_cfg=rcfg, encoder_cfg=CLIPVisionConfig.tiny(),
                encoder_params=_random_tree(lambda: CLIPVision(CLIPVisionConfig.tiny()),
                                            "clip_vision", rng))


def _box_masks(rng, n: int, size: int) -> list[np.ndarray]:
    """Foreground masks of two roles, (n, size, size) each: one box per image."""
    masks = np.zeros((2, n, size, size), np.float32)
    for m in masks.reshape(-1, size, size):
        y, x = rng.integers(0, size // 2, 2)
        m[y:y + size // 3, x:x + size // 3] = 1.0
    return list(masks)


def tiny_surface_phase() -> None:
    phase("end to end, this slice's SD-1.5 paths at tiny width in float32: card vs CPU "
          "(|dscore| <= 1e-4 and <= atol + 1e-4 of the distance): a tiny IP-Adapter-plus at 32 "
          "px (K1, K2), masked queries at 32 px and at 64 px (1024-token tap -> K3), "
          "score_feats_batch (diffeats)")
    rng = np.random.default_rng(2337)
    cfgs = dict(unet_cfg=UNetConfig.tiny(), vae_cfg=VAEConfig.tiny(),
                text_cfg=CLIPTextConfig.tiny())
    params = {"unet": _random_tree(lambda: UNet(cfgs["unet_cfg"]), "unet", rng),
              "vae": _random_tree(lambda: Encoder(cfgs["vae_cfg"]), "vae", rng),
              "text": _random_tree(lambda: CLIPText(cfgs["text_cfg"]), "text", rng)}
    ip = _random_ip(cfgs["unet_cfg"], rng)

    def make(size, with_ip=False):
        def make_scorer(device):
            scorer = DiffSimSD15(params, img_size=size, dtype=torch.float32, device=device,
                                 tokenizer=HashTokenizer(cfgs["text_cfg"].vocab_size), **cfgs)
            if with_ip:
                scorer.enable_ip_adapter(**ip)
            return scorer
        return make_scorer

    data = {}
    for size in (32, 64):
        pix = [rng.integers(0, 256, (2, size, size, 3), dtype=np.uint8) for _ in range(2)]
        noise = tuple(rng.standard_normal((2, size // 2, size // 2, 4)).astype(np.float32)
                      for _ in range(2))
        ma, mb = _box_masks(rng, 2, size)
        data[size] = (*pix, noise, {"mask_a": ma, "mask_b": mb})
    with tf32_off():
        a, b, noise, masks = data[32]
        _card_vs_cpu("tiny SD-1.5 IP-Adapter", make(32, True), a, b, noise,
                     {**IPREF, "ip_adapter": True}, TINY_SD15_IP_CALL)
        _card_vs_cpu("tiny SD-1.5 masked", make(32), a, b, noise, {**CUTE, **masks},
                     TINY_SD15_CALL)
        _card_vs_cpu("tiny SD-1.5 diffeats", make(32), a, b, noise, CUTE, TINY_SD15_IP_CALL,
                     method="score_feats_batch")
        a, b, noise, masks = data[64]
        _card_vs_cpu("tiny SD-1.5 masked at 64 px", make(64), a, b, noise, {**CUTE, **masks},
                     TINY_SD15_K3_CALL)


def _checked_call(name: str, fn, expected: dict, none_in_mode: bool = False,
                  all_float32: bool = False):
    """Run one scoring call with the launch counts at zero; fail unless it launched exactly the
    ``expected`` kernels, with ``none_in_mode`` none in the bf16_probs mode, and with
    ``all_float32`` every one on float32 tensors."""
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"  {name}: launches {counts}", flush=True)
    if counts != {**NONE, **expected}:
        raise SystemExit(f"{name}: expected launches {expected}")
    fast = kernels.bf16_probs_launch_counts()
    if none_in_mode and any(fast.values()):
        raise SystemExit(f"{name}: launches in the bf16_probs mode {fast}")
    f32 = kernels.float32_launch_counts()
    if all_float32 and f32 != counts:
        raise SystemExit(f"{name}: launches on float32 tensors {f32}, not all of them")
    return out, counts


def _check_scores(name: str, *arrays) -> None:
    for a in arrays:
        if not (np.isfinite(a).all() and (np.abs(a) <= 1.0 + 1e-6).all()):
            raise SystemExit(f"{name}: scores not finite in [-1, 1]: {a}")


def _drive(name, scorer, pix, args, card_line, calls, diffsim) -> dict:
    """The shared main-path drive: a triplet call with its exact launches, a timed repeat that
    must give the same scores, a 2-pair score_batch and the path entry point on two PNGs."""
    pix_a, pix_b, pix_c = pix
    torch.cuda.reset_peak_memory_stats()
    (s_ab, s_ac), counts = _checked_call(
        f"score_triplet_batch ({len(pix_a)} triplets)",
        lambda: scorer.score_triplet_batch(pix_a, pix_b, pix_c, **args), calls["triplet"])
    _check_scores("score_triplet_batch", s_ab, s_ac)
    t0 = time.perf_counter()
    again_ab, again_ac = scorer.score_triplet_batch(pix_a, pix_b, pix_c, **args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not (np.array_equal(again_ab, s_ab) and np.array_equal(again_ac, s_ac)):
        raise SystemExit(f"{name} score_triplet_batch: a repeat call gave other scores")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  s_ab {s_ab}\n  s_ac {s_ac}")
    print(f"  peak device memory {peak:.2f} GiB")
    print(f"  repeat call {wall * 1e3:.1f} ms: {2 * len(pix_a) / wall:.2f} pairs/s on {card_line} "
          "(information only, not a benchmark)", flush=True)
    pairs, _ = _checked_call("score_batch (2 pairs)", lambda: scorer.score_batch(
        pix_a[:2], pix_b[:2], **args), calls["pairs"])
    _check_scores("score_batch", pairs)
    print(f"  score_batch {pairs} vs s_ab[:2] {s_ab[:2]}")
    if not np.allclose(pairs, s_ab[:2], atol=1e-2):
        raise SystemExit("score_batch disagrees with score_triplet_batch's s_ab beyond 1e-2")
    from PIL import Image

    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"{i}.png") for i in range(2)]
        for path, arr in zip(paths, (pix_a[0], pix_b[0])):
            Image.fromarray(arr).save(path)
        score, _ = _checked_call(f"{diffsim}(a.png, b.png)", lambda: getattr(scorer, diffsim)(
            paths[0], paths[1], **args), calls["one_pair"])
    _check_scores(diffsim, np.array([score]))
    print(f"  {diffsim}(a.png, b.png) = {score}", flush=True)
    return {"counts": counts, "peak_gib": peak, "repeat_ms": wall * 1e3, "scores": (s_ab, s_ac)}


def sd15_phase(card_line: str) -> dict:
    phase("main path: SD-1.5 at full width, 512 px, bf16, canonical CUTE tap")
    t0 = time.perf_counter()
    scorer = DiffSimSD15(img_size=512)  # cuda, bf16, random weights from a seeded generator
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (scorer.unet, scorer.vae, scorer.text)
                   for p in m.parameters())
    print(f"  init {time.perf_counter() - t0:.2f} s, {n_params / 1e6:.1f} M parameters")
    rng = np.random.default_rng(0)
    pix = [rng.integers(0, 256, (4, 512, 512, 3), dtype=np.uint8) for _ in range(3)]
    out = _drive("SD-1.5", scorer, pix, CUTE, card_line,
                 {"triplet": SD15_CALL, "pairs": SD15_CALL, "one_pair": SD15_CALL}, "diffsim")
    profile_call(lambda: scorer.score_triplet_batch(*pix, **CUTE), "SD-1.5 triplet call")
    phase("SD-1.5 at the up-block-2 tap (target_layer=[1], fix_layer_collapse): K3 readout")
    k3_args = {**CUTE, "target_layer": [1]}
    scores, _ = _checked_call("score_batch (2 pairs, up block 2)", lambda: scorer.score_batch(
        pix[0][:2], pix[1][:2], fix_layer_collapse=True, **k3_args), SD15_K3_CALL)
    _check_scores("score_batch at up block 2", scores)
    print(f"  scores {scores}", flush=True)
    out["guard"] = guard_slope("SD-1.5 512 px", scorer, CUTE, (8, 16), 512, card_line)
    out["pair_guard"] = pair_slope("SD-1.5 512 px", scorer, CUTE, (8, 16), 512, card_line)
    out["refusal"] = pair_refusal(scorer, CUTE, 16, 512, card_line)
    out["surface"] = sd15_surface(scorer, pix)
    phase("SD-1.5 IP-Adapter-plus at full width, 512 px: CLIP ViT-H/14 and the sd15_plus "
          "Resampler, random weights on the card; the ipref preset's arguments (target_layer 5 "
          "collapses to up block 1, attn2), t = 750")
    out["ip"] = ip_drive("SD-1.5", scorer, pix[0][:2], pix[1][:2], IPREF, SD15_IP_CALL,
                         card_line)
    out["ip_pair_guard"] = pair_slope("SD-1.5 IP-Adapter 512 px", scorer,
                                      {**IPREF, "ip_adapter": True}, (8, 16), 512, card_line)
    return out


def sd15_surface(scorer, pix) -> dict:
    """Masked queries at the canonical tap and at up block 2 (K3), ``score_feats_batch`` and
    ``tap_values`` at full SD-1.5 width, each with its exact launches."""
    phase("SD-1.5 surface at full width, 512 px: masked score_batch (canonical tap; up block 2 "
          "-> K3), score_feats_batch (diffeats), tap_values on a PNG")
    from PIL import Image

    a, b = pix[0][:2], pix[1][:2]
    ma, mb = _box_masks(np.random.default_rng(8), 2, 512)
    counts = {}
    masked, counts["sd15_masked"] = _checked_call(
        "score_batch with masks (2 pairs)",
        lambda: scorer.score_batch(a, b, mask_a=ma, mask_b=mb, **CUTE), SD15_CALL)
    unmasked = scorer.score_batch(a, b, **CUTE)
    k3, counts["sd15_masked_k3"] = _checked_call(
        "score_batch with masks (2 pairs, up block 2: K3)",
        lambda: scorer.score_batch(a, b, mask_a=ma, mask_b=mb, fix_layer_collapse=True,
                                   **{**CUTE, "target_layer": [1]}), SD15_K3_CALL)
    feats, counts["sd15_feats"] = _checked_call(
        "score_feats_batch (2 pairs)", lambda: scorer.score_feats_batch(a, b, **CUTE),
        SD15_IP_CALL)
    _check_scores("the surface", masked, k3, feats)
    if np.allclose(masked, unmasked):
        raise SystemExit("the masks did not change the scores")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "a.png")
        Image.fromarray(a[0]).save(path)
        qkv, counts["sd15_tap_values"] = _checked_call(
            "tap_values(a.png)", lambda: scorer.tap_values(path, **{
                k: v for k, v in CUTE.items() if k != "similarity"}), SD15_CALL)
    shapes = [tuple(t.shape) for t in qkv]
    print(f"  masked {masked} (unmasked {unmasked}); up block 2 masked {k3}; diffeats {feats}; "
          f"tap_values shapes {shapes}", flush=True)
    if shapes != [(2, 8, 256, 160)] * 3 or not all(torch.isfinite(t).all() for t in qkv):
        raise SystemExit(f"tap_values gave {shapes} or non-finite values")
    return counts


def ip_drive(name, scorer, pix_a, pix_b, args, expected, card_line) -> dict:
    """Attach a random IP-Adapter-plus (CLIP ViT-H/14 and the backbone's published Resampler,
    drawn on the card) to a full-width scorer and run ``score_batch(ip_adapter=True)`` on two
    pairs: exact launches, finite cosines, a repeat bit for bit; its time (CUDA events, host
    work in) and peak memory as information."""
    t0 = time.perf_counter()
    scorer.enable_ip_adapter()
    torch.cuda.synchronize()
    n_enc = sum(p.numel() for p in scorer.ip_encoder.parameters()) / 1e6
    n_proj = sum(p.numel() for p in scorer.ip_proj.parameters()) / 1e6
    n_kv = sum(p.numel() for a in attn2_modules(scorer.unet) for p in a.ip.parameters()) / 1e6
    print(f"  enable_ip_adapter {time.perf_counter() - t0:.2f} s: encoder {n_enc:.1f} M, "
          f"Resampler {n_proj:.1f} M, {len(attn2_modules(scorer.unet))} attn2 K/V pairs "
          f"{n_kv:.1f} M parameters; the device-memory guard counts "
          f"{hbm_guard.scorer_static_bytes(scorer) / 1e9:.2f} GB static", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    scores, counts = _checked_call(f"{name} score_batch(ip_adapter=True) (2 pairs)",
                                   lambda: scorer.score_batch(pix_a, pix_b, ip_adapter=True,
                                                              **args), expected)
    peak = torch.cuda.max_memory_allocated() / 2**30
    _check_scores(f"{name} IP-Adapter", scores)
    again = scorer.score_batch(pix_a, pix_b, ip_adapter=True, **args)
    if not np.array_equal(again, scores):
        raise SystemExit(f"{name} score_batch(ip_adapter=True): a repeat call gave other scores")
    call_ms = time_ms(lambda: scorer.score_batch(pix_a, pix_b, ip_adapter=True, **args), reps=5,
                      warmup=1)
    plain_ms = time_ms(lambda: scorer.score_batch(pix_a, pix_b, **args), reps=5, warmup=1)
    print(f"  {name} IP scores {scores}, repeat bit for bit; call {call_ms:.1f} ms, the same "
          f"pairs without the adapter (attn1 tap) {plain_ms:.1f} ms (medians of 5, CUDA events, "
          f"host work in); peak device memory {peak:.2f} GiB on {card_line} (information only)",
          flush=True)
    return {"counts": counts, "call_ms": call_ms, "no_ip_call_ms": plain_ms, "peak_gib": peak}


def sdxl_phase(card_line: str) -> dict:
    phase("main path: SDXL at full width, 1024 px, bf16 with the float32 VAE, tap (0, 1, 1)")
    t0 = time.perf_counter()
    scorer = DiffSimXL(img_size=1024)  # cuda, bf16, random weights from a seeded generator
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (scorer.unet, scorer.vae, scorer.text, scorer.text2)
                   for p in m.parameters())
    print(f"  init {time.perf_counter() - t0:.2f} s, {n_params / 1e6:.1f} M parameters")
    rng = np.random.default_rng(1)
    pix = [rng.integers(0, 256, (XL_T, 1024, 1024, 3), dtype=np.uint8) for _ in range(3)]
    out = _drive("SDXL", scorer, pix, XL_ARGS, card_line,
                 {"triplet": XL_TRIPLET_CALL, "pairs": XL_PAIRS_CALL,
                  "one_pair": XL_ONE_PAIR_CALL}, "diffsim_score")
    profile_call(lambda: scorer.score_triplet_batch(*pix, **XL_ARGS), "SDXL triplet call")
    # the float32 VAE encode of the call's six images against the whole call (CUDA events)
    x = to_device_pixels(pix, scorer.device, scorer.enc_dtype)
    with torch.inference_mode():
        vae_ms = time_ms(lambda: encode_chunked(scorer.vae, x), reps=3, warmup=1)
    call_ms = time_ms(lambda: scorer.score_triplet_batch(*pix, **XL_ARGS), reps=3, warmup=1)
    print(f"  layers of one SDXL triplet call: VAE encode {vae_ms:.1f} ms of {call_ms:.1f} ms "
          f"({100 * vae_ms / call_ms:.1f} %), text cache, UNet to the tap and readout the rest",
          flush=True)
    out["vae_split"] = {"vae_ms": vae_ms, "call_ms": call_ms}
    out["pix"] = pix
    phase("SDXL through the device moment cache: score_triplet_paths on the same two triplets")
    # six images in one miss slab: three 2-image VAE slices
    out["cached_gap"] = cached_path("SDXL", scorer, pix, *out["scores"], XL_ARGS,
                                    XL_TRIPLET_CALL, {**XL_FORWARD, "cross_self_partials": 4})
    out["guard"] = guard_slope("SDXL 1024 px", scorer, XL_ARGS, (2, 4), 1024, card_line)
    out["pair_guard"] = pair_slope("SDXL 1024 px", scorer, XL_ARGS, (2, 4), 1024, card_line)
    del x
    phase("SDXL IP-Adapter-plus at full width, 1024 px: CLIP ViT-H/14 and the sdxl_plus "
          "Resampler, random weights on the card; tap up (0, 1, 1) attn2, t = 900")
    out["ip"] = ip_drive("SDXL", scorer, pix[0], pix[1], XL_ARGS, XL_IP_PAIRS_CALL, card_line)
    out["ip_pair_guard"] = pair_slope("SDXL IP-Adapter 1024 px", scorer,
                                      {**XL_ARGS, "ip_adapter": True}, (2, 4), 1024, card_line)
    return out


# The SDXL --xl_vae_bf16 call with K4 against the same call with the VAE's mid attention by
# streaming_self_attention_plain: both in bf16, the kernel's online softmax against the plain
# version's whole-row one. With random weights the scores hardly depend on the images: the
# control, the same call with the mid attention's output replaced by V, moves them by less than
# the kernel does (7.689e-06 against 8.583e-06 on an H100), so the scores' limit is a sanity
# bound only. The VAE's moments (the encode's output), as |d| / |plain| over all of them, carry
# the comparison: their limit lies between the sound call's reading (3.676e-03) and the
# control's (9.060e-02), and the control must exceed it.
XL_BF16_VAE_TOL = 1e-3  # scores, max |d|
XL_BF16_MOMENTS_TOL = 1e-2  # moments, relative


def sdxl_bf16_vae_phase(card_line: str, pix, f32_split: dict) -> dict:
    phase("main path: SDXL at full width, 1024 px, with the bf16 VAE: --metric diffsim_xl "
          "--xl_vae_bf16 through cli.args and metrics.registry (K4's bf16 path, 2 a triplet call)")
    t0 = time.perf_counter()
    args = arg_parse(["--metric", "diffsim_xl", "--xl_vae_bf16", "--image_size", "1024"])
    scorer = registry.build_metric(args).scorer  # cuda, bf16, random weights from a seed
    torch.cuda.synchronize()
    if scorer.enc_dtype != torch.bfloat16:
        raise SystemExit(f"--xl_vae_bf16 gave the scorer a {scorer.enc_dtype} VAE")
    print(f"  init {time.perf_counter() - t0:.2f} s", flush=True)

    (s_ab, s_ac), counts = _checked_call(
        f"score_triplet_batch ({XL_T} triplets)",
        lambda: scorer.score_triplet_batch(*pix, **XL_ARGS), XL_BF16_TRIPLET_CALL, True)
    _check_scores("score_triplet_batch, bf16 VAE", s_ab, s_ac)
    print(f"  s_ab {s_ab}\n  s_ac {s_ac}", flush=True)
    # the same call with the VAE's mid attention taken by the plain version, and by the control
    # (this script only)
    from diffsim_tpu_torch.ops import attention as ops_attention

    x = to_device_pixels(pix, scorer.device, scorer.enc_dtype)

    def moments() -> torch.Tensor:
        with torch.inference_mode():
            return encode_chunked(scorer.vae, x).float()

    z = moments()
    kernel = ops_attention.streaming_self_attention
    gaps = {}
    for what, attn in (
            ("streaming_self_attention_plain",
             lambda q, k, v, bf16_probs=False: streaming_self_attention_plain(q, k, v, bf16_probs)),
            ("the control, V", lambda q, k, v, bf16_probs=False: v)):
        ops_attention.streaming_self_attention = attn
        try:
            (p_ab, p_ac), _ = _checked_call(
                f"score_triplet_batch, K4 by {what}",
                lambda: scorer.score_triplet_batch(*pix, **XL_ARGS),
                {**XL_BF16_TRIPLET_CALL, "streaming_self_attention": 0})
            zp = moments()
        finally:
            ops_attention.streaming_self_attention = kernel
        gaps[what] = (float(max(np.abs(s_ab - p_ab).max(), np.abs(s_ac - p_ac).max())),
                      ((z - zp).norm() / zp.norm()).item())
        print(f"  K4 by {what}: scores {p_ab} {p_ac}, max |d| = {gaps[what][0]:.3e} (limit "
              f"{XL_BF16_VAE_TOL}); moments |d| / |plain| = {gaps[what][1]:.3e} (limit "
              f"{XL_BF16_MOMENTS_TOL})", flush=True)
    (gap, z_gap), (ctl_gap, ctl_z_gap) = gaps.values()
    del z, zp
    if not (gap <= XL_BF16_VAE_TOL and z_gap <= XL_BF16_MOMENTS_TOL):
        raise SystemExit("SDXL --xl_vae_bf16: the K4 call disagrees with the plain K4's")
    if not ctl_z_gap > XL_BF16_MOMENTS_TOL:
        raise SystemExit("SDXL --xl_vae_bf16: the control does not exceed the moments' limit")
    hit_calls = {**XL_FORWARD, "cross_self_partials": 4}
    cached_gap = cached_path("SDXL bf16 VAE", scorer, pix, s_ab, s_ac, XL_ARGS,
                             XL_BF16_TRIPLET_CALL, hit_calls, True)
    with torch.inference_mode():
        vae_ms = time_ms(lambda: encode_chunked(scorer.vae, x), reps=3, warmup=1)
    call_ms = time_ms(lambda: scorer.score_triplet_batch(*pix, **XL_ARGS), reps=3, warmup=1)
    print(f"  layers of one SDXL triplet call on {card_line}: bf16 VAE encode {vae_ms:.1f} ms of "
          f"{call_ms:.1f} ms ({100 * vae_ms / call_ms:.1f} %); the float32 VAE's "
          f"{f32_split['vae_ms']:.1f} ms of {f32_split['call_ms']:.1f} ms "
          f"({100 * f32_split['vae_ms'] / f32_split['call_ms']:.1f} %) (CUDA events, medians of 3)",
          flush=True)
    del x, scorer
    torch.cuda.empty_cache()
    return {"counts": counts, "plain_k4_gap": gap, "plain_k4_moments_gap": z_gap,
            "control_gap": ctl_gap, "control_moments_gap": ctl_z_gap, "cached_gap": cached_gap,
            "vae_ms": vae_ms, "call_ms": call_ms}


def tiny_dit_phase() -> None:
    phase("end to end, tiny DiT at 128 px in float32, tap block 1 of head dim 72 at 1024 tokens "
          "(DiT-XL/2's at 512 px): card vs CPU (|dscore| <= 1e-4 and <= atol + 1e-4 of the "
          "distance; DiT attention -> K1 at hd 72, tap -> K3 at hd 72, the tiny VAE's mid "
          "attention 4096 tokens at D 64 -> K1)")
    rng = np.random.default_rng(2336)
    cfgs = dict(dit_cfg=DiTConfig(**TINY_DIT), vae_cfg=VAEConfig.tiny())
    params = {"dit": _random_tree(lambda: DiT(cfgs["dit_cfg"]), "dit", rng),
              "vae": _random_tree(lambda: Encoder(cfgs["vae_cfg"]), "vae", rng)}
    pix_a, pix_b = (rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8) for _ in range(2))
    noise = tuple(rng.standard_normal((2, 64, 64, 4)).astype(np.float32) for _ in range(2))
    with tf32_off():
        _card_vs_cpu("tiny DiT", lambda device: DiffSimDiT(
            params, img_size=128, dtype=torch.float32, device=device, **cfgs),
            pix_a, pix_b, noise, {**DIT_ARGS, "target_layer": 1}, TINY_DIT_CALL)


def dit_phase(card_line: str) -> dict:
    phase("main path: DiT-XL/2 at full width, 512 px, bf16, tap block 13, t = 600, 8 triplets "
          "(bench_backbones.py)")
    t0 = time.perf_counter()
    scorer = DiffSimDiT(img_size=512)  # cuda, bf16, random weights from a seeded generator
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (scorer.dit, scorer.vae) for p in m.parameters())
    print(f"  init {time.perf_counter() - t0:.2f} s, {n_params / 1e6:.1f} M parameters")
    rng = np.random.default_rng(5)
    pix = [rng.integers(0, 256, (DIT_T, 512, 512, 3), dtype=np.uint8) for _ in range(3)]
    out = _drive("DiT-XL/2", scorer, pix, DIT_ARGS, card_line,
                 {"triplet": DIT_TRIPLET_CALL, "pairs": DIT_PAIRS_CALL,
                  "one_pair": DIT_PAIRS_CALL}, "diffsim_score")
    profile_call(lambda: scorer.score_triplet_batch(*pix, **DIT_ARGS), "DiT-XL/2 triplet call")
    x = to_device_pixels(pix, scorer.device, scorer.dtype)
    with torch.inference_mode():
        vae_ms = time_ms(lambda: encode_chunked(scorer.vae, x), reps=3, warmup=1)
    call_ms = time_ms(lambda: scorer.score_triplet_batch(*pix, **DIT_ARGS), reps=3, warmup=1)
    print(f"  layers of one DiT-XL/2 triplet call: VAE encode {vae_ms:.1f} ms of {call_ms:.1f} ms "
          f"({100 * vae_ms / call_ms:.1f} %), DiT to the tap and readout the rest", flush=True)
    del x
    phase("DiT-XL/2 through the device moment cache: score_triplet_paths on the same 8 triplets")
    out["cached_gap"] = cached_path("DiT-XL/2", scorer, pix, *out["scores"], DIT_ARGS,
                                    DIT_TRIPLET_CALL, DIT_TRIPLET_CALL)
    out["guard"] = guard_slope("DiT-XL/2 512 px", scorer, DIT_ARGS, (8, 16), 512, card_line)
    out["pair_guard"] = pair_slope("DiT-XL/2 512 px", scorer, DIT_ARGS, (8, 16), 512, card_line)
    return out


# ---------------------------------------------------------------------------
# The float32 scorers at full width (dtype=torch.float32): K2 and K3 on their float32 paths
# ---------------------------------------------------------------------------

# Each float32 call's scores against the same call with K2's and K3's plain versions swapped in
# (this script only): |d| <= F32_SCORE_TOL[0] + F32_SCORE_TOL[1] x the plain call's distance
# (1 - cosine). The control, the plain versions with GEMM2's first 32-column k panel (K2) and
# keys [32, 64) of every 64-key tile (K3) left out, as a kernel that lost one panel sum or one
# warp's key slice would compute, must exceed that limit.
F32_SCORE_TOL = (1e-5, 1e-5)
F32_DROP = (32, 64)
SD15_K3_TRIPLET_CALL = {**SD15_K3_CALL, "cross_self_partials": 4}
F32_PER = {"sd15": "one SD-1.5 UNet forward at B=24 in float32 (sum over its launches)",
           "sd15_k3": ("one SD-1.5 score_triplet_batch call at the up-block-2 tap in float32 (4 "
                       "triplets, 512 px), the sum over its launches"),
           "sdxl": (f"one SDXL score_triplet_batch call in float32 ({XL_T} triplets, 1024 px), "
                    "the sum over its launches"),
           "dit": (f"one DiT-XL/2 score_triplet_batch call in float32 ({DIT_T} triplets, 512 px, "
                   "tap block 13), the sum over its launches")}


def _k2_control(x, w1, b1, w2, b2):
    """K2's plain version with GEMM2's k columns [0, 32) left out."""
    w2 = w2.clone()
    w2[:, :F32_DROP[0]] = 0
    return fused_geglu_ff_plain(x, w1, b1, w2, b2)


def _k3_control(qa, ka, va, kb, vb, similarity="cosine"):
    """K3's plain version with keys [32, 64) of every 64-key tile left out of both passes."""
    keep = torch.arange(qa.shape[-2], device=qa.device) % F32_DROP[1] < F32_DROP[0]

    def partials(q, k1, v1, k2, v2, mse=False):
        return readout.cross_self_partials_plain(q, k1[:, keep], v1[:, keep], k2[:, keep],
                                                 v2[:, keep], mse)
    return readout._direction_score(partials, qa, ka, va, kb, vb, similarity)


@contextlib.contextmanager
def _k2_k3_by(ff, score):
    """K2 and K3 as the scorers reach them (``ops.blocks``, ``metrics.readout``) replaced by
    ``ff`` and ``score`` within the block."""
    from diffsim_tpu_torch.metrics import readout as metrics_readout
    from diffsim_tpu_torch.ops import blocks

    kept = blocks.fused_geglu_ff, metrics_readout.fused_direction_score
    blocks.fused_geglu_ff, metrics_readout.fused_direction_score = ff, score
    try:
        yield
    finally:
        blocks.fused_geglu_ff, metrics_readout.fused_direction_score = kept


def f32_call(name, scorer, pix, args, expected, bf16_ms) -> dict:
    """One float32 triplet call at full width: its launches (all on float32 tensors), a repeat
    bit for bit, its time, peak memory and its bf16 counterpart's time, and its scores against
    the same call with K2's and K3's plain versions and with the control."""
    t = len(pix[0])
    call = functools.partial(scorer.score_triplet_batch, *pix, **args)
    torch.cuda.reset_peak_memory_stats()
    (s_ab, s_ac), counts = _checked_call(f"{name} score_triplet_batch ({t} triplets, float32)",
                                         call, expected, all_float32=True)
    _check_scores(name, s_ab, s_ac)
    t0 = time.perf_counter()
    again = call()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    if not (np.array_equal(again[0], s_ab) and np.array_equal(again[1], s_ac)):
        raise SystemExit(f"{name} float32: a repeat call gave other scores")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  s_ab {s_ab}\n  s_ac {s_ac}\n  repeat call {wall:.1f} ms ({2 * t * 1e3 / wall:.2f} "
          f"pairs/s), peak device memory {peak:.2f} GiB; the bf16 scorer's repeat call "
          f"{bf16_ms:.1f} ms (information only, not a benchmark)", flush=True)
    profile_call(call, f"{name} float32 triplet call")
    swapped = {**expected, "fused_geglu_ff": 0, "cross_self_partials": 0}
    with _k2_k3_by(fused_geglu_ff_plain, fused_direction_score_plain):
        plain, _ = _checked_call(f"{name}, K2 and K3 by their plain versions", call, swapped)
    with _k2_k3_by(_k2_control, _k3_control):
        ctl, _ = _checked_call(f"{name}, K2 and K3 by the control", call, swapped)
    plain, ctl = np.concatenate(plain), np.concatenate(ctl)
    lim = F32_SCORE_TOL[0] + F32_SCORE_TOL[1] * np.abs(1.0 - plain)
    gap, ctl_gap = np.abs(np.concatenate([s_ab, s_ac]) - plain), np.abs(ctl - plain)
    share, ctl_share = float((gap / lim).max()), float((ctl_gap / lim).max())
    print(f"  against the plain K2 and K3: max |d| = {gap.max():.3e}, / limit {share:.3f} (limit "
          f"{F32_SCORE_TOL[0]} + {F32_SCORE_TOL[1]} x the distance); the control (K2 without "
          f"GEMM2's k panel [0, {F32_DROP[0]}), K3 without keys [{F32_DROP[0]}, {F32_DROP[1]}) of "
          "each tile): "
          f"max |d| = {ctl_gap.max():.3e}, / limit {ctl_share:.3f} "
          f"({'fails the limit: ok' if ctl_share > 1 else 'within the limit: FAIL'})", flush=True)
    if not share <= 1.0:
        raise SystemExit(f"{name} float32: the kernels' scores disagree with the plain K2 and K3")
    if not ctl_share > 1.0:
        raise SystemExit(f"{name} float32: the control passes the limit")
    return {"counts": counts, "scores": (s_ab, s_ac), "repeat_ms": wall, "peak_gib": peak,
            "bf16_repeat_ms": bf16_ms, "plain_limit_share": share,
            "control_limit_share": ctl_share}


def f32_scoring_phase(card_line: str, bf16_ms: dict) -> dict:
    """The float32 scorers at full width with random weights from a seeded generator: SD-1.5 at
    512 px (the canonical CUTE tap and the up-block-2 tap, 4 triplets), SDXL at 1024 px (2
    triplets) and DiT-XL/2 at 512 px (8 triplets), each with its cached path and the guard's
    slope."""
    out = {}
    phase(f"float32 scoring at full width: SD-1.5, 512 px, dtype=torch.float32, 4 triplets at the "
          f"canonical tap and at up block 2 (K2 and K3 on their float32 paths); scores against the "
          f"plain K2 and K3 within {F32_SCORE_TOL[0]} + {F32_SCORE_TOL[1]} of the distance")
    scorer = DiffSimSD15(img_size=512, dtype=torch.float32)
    rng = np.random.default_rng(0)
    pix = [rng.integers(0, 256, (4, 512, 512, 3), dtype=np.uint8) for _ in range(3)]
    res = f32_call("SD-1.5", scorer, pix, CUTE, SD15_CALL, bf16_ms["sd15"])
    res["cached_gap"] = cached_path("SD-1.5 float32", scorer, pix, *res["scores"], CUTE,
                                    SD15_CALL, SD15_CALL, all_float32=True)
    out["sd15"] = res
    out["sd15_k3"] = f32_call("SD-1.5 up block 2", scorer, pix,
                              {**CUTE, "target_layer": [1], "fix_layer_collapse": True},
                              SD15_K3_TRIPLET_CALL, bf16_ms["sd15"])
    out["sd15"]["guard"] = guard_slope("SD-1.5 512 px float32", scorer, CUTE, (8, 16), 512,
                                       card_line)
    out["sd15"]["pair_guard"] = pair_slope("SD-1.5 512 px float32", scorer, CUTE, (8, 16), 512,
                                           card_line)
    del scorer
    torch.cuda.empty_cache()
    phase("float32 scoring at full width: SDXL, 1024 px, dtype=torch.float32, tap (0, 1, 1), "
          f"{XL_T} triplets (bench_backbones.py)")
    scorer = DiffSimXL(img_size=1024, dtype=torch.float32)
    rng = np.random.default_rng(1)
    pix = [rng.integers(0, 256, (XL_T, 1024, 1024, 3), dtype=np.uint8) for _ in range(3)]
    res = f32_call("SDXL", scorer, pix, XL_ARGS, XL_TRIPLET_CALL, bf16_ms["sdxl"])
    res["cached_gap"] = cached_path("SDXL float32", scorer, pix, *res["scores"], XL_ARGS,
                                    XL_TRIPLET_CALL, {**XL_FORWARD, "cross_self_partials": 4},
                                    all_float32=True)
    res["guard"] = guard_slope("SDXL 1024 px float32", scorer, XL_ARGS, (2, 4), 1024, card_line)
    res["pair_guard"] = pair_slope("SDXL 1024 px float32", scorer, XL_ARGS, (2, 4), 1024,
                                   card_line)
    out["sdxl"] = res
    del scorer
    torch.cuda.empty_cache()
    phase(f"float32 scoring at full width: DiT-XL/2, 512 px, dtype=torch.float32, tap block 13, "
          f"{DIT_T} triplets (bench_backbones.py)")
    scorer = DiffSimDiT(img_size=512, dtype=torch.float32)
    rng = np.random.default_rng(5)
    pix = [rng.integers(0, 256, (DIT_T, 512, 512, 3), dtype=np.uint8) for _ in range(3)]
    res = f32_call("DiT-XL/2", scorer, pix, DIT_ARGS, DIT_TRIPLET_CALL, bf16_ms["dit"])
    res["cached_gap"] = cached_path("DiT-XL/2 float32", scorer, pix, *res["scores"], DIT_ARGS,
                                    DIT_TRIPLET_CALL, DIT_TRIPLET_CALL, all_float32=True)
    res["guard"] = guard_slope("DiT-XL/2 512 px float32", scorer, DIT_ARGS, (8, 16), 512,
                               card_line)
    res["pair_guard"] = pair_slope("DiT-XL/2 512 px float32", scorer, DIT_ARGS, (8, 16), 512,
                                   card_line)
    out["dit"] = res
    del scorer
    torch.cuda.empty_cache()
    return out


def _mode_row(row, kernel, plain, flops, nbytes, *, exact, dtype, exps, tf32_passes=0.0,
              plain_reps=20, v2=None):
    """Time a kernel's bf16_probs mode as ``_timed`` does, with its exact mode and SDPA (exact
    float32 or bf16 softmax) beside it as information: no PyTorch call computes attention with
    bf16 probabilities, so the mode has no library time. ``v2`` is the mode in the kernel's
    previous design."""
    q, k, v = exact
    _timed(row, kernel, plain, flops, nbytes, dtype=dtype, exps=exps, tf32_passes=tf32_passes,
           plain_reps=plain_reps, v2=v2,
           info={"exact_ms": lambda: (fused_self_attention if q.shape[-1] <= 160
                                      else streaming_self_attention)(q, k, v),
                 "sdpa_exact_ms": lambda: F.scaled_dot_product_attention(q, k, v)})


def k1_fast_phase(gen) -> dict:
    phase("K1 fused_self_attention, bf16_probs mode (--bf16_softmax) vs plain (bf16 and float32 "
          "atol=rtol=1e-2: the kernel rounds each probability to bf16 before the row sum, the "
          "plain version sums them in float32 as XLA's CPU compiler does), then vs the kernels' "
          "own rounding on planted inputs, against the exact mode")
    shapes = [(*site, torch.bfloat16) for site in K1_FAST_SITES]
    shapes.append((2, 8, 1024, 80, torch.float32))
    rows, main_err = [], 0.0
    for b, h, s, d, dtype in shapes:
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        out = fused_self_attention(q, k, v, True)
        torch.cuda.synchronize()
        ref = fused_self_attention_plain(q, k, v, True)
        err = check_close(f"K1 bf16_probs {(b, h, s, d)} {dtype}", out, ref, 1e-2, 1e-2)
        del out, ref
        row = {"shape": [b, h, s, d], "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": err}
        f32 = dtype == torch.float32
        row["rounding"] = check_rounding(f"K1 bf16_probs {(b, h, s, d)} {dtype}",
                                         fused_self_attention, (b, h, s, d), dtype, gen,
                                         tc_steps=K1_F32_TC_STEPS if f32 else None)
        torch.cuda.empty_cache()
        sd15_site = K1_SITES.get((b, h, s, d), (0,))[0] and not f32
        if sd15_site:
            main_err = max(main_err, err)  # the sites of the SD-1.5 tail in fast mode
            row["launches_sd15_forward"] = K1_SITES[(b, h, s, d)][0]
        if sd15_site or f32:
            # float32 beside its previous (FMA) design, which is held to the plain version too;
            # Q K^T in 3 TF32 products, P V (P exact in TF32) in 2
            _mode_row(row, lambda: fused_self_attention(q, k, v, True),
                      lambda: fused_self_attention_plain(q, k, v, True),
                      4 * b * h * s * s * d, 4 * b * h * s * d * q.element_size(),
                      exact=(q, k, v), dtype=dtype, exps=b * h * s * s,
                      tf32_passes=2.5 if f32 else 0.0,
                      v2=v2_f32_attention(q, k, v, (1e-2, 1e-2), True) if f32 else None)
            row["ratio_to_exact"] = row["ms"] / row["exact_ms"]
            print(f"    {(b, h, s, d)} {dtype}: the mode {row['ratio_to_exact']:.3f}x the exact "
                  "mode's device time", flush=True)
        rows.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    return {"rows": rows, "max_abs_err": main_err}


def k4_fast_phase(gen) -> dict:
    phase("K4 streaming_self_attention, bf16_probs mode vs plain (float32 and bf16 "
          "atol=rtol=1e-2), then vs the kernels' own rounding on planted inputs, against the "
          "exact mode; timed beside the exact mode")
    shapes = [(K4_MAIN, torch.float32), (K4_MAIN, torch.bfloat16), (K4_768, torch.bfloat16)]
    rows, main_err = [], 0.0
    for shape, dtype in shapes:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
        out = streaming_self_attention(q, k, v, True)
        torch.cuda.synchronize()
        ref = streaming_self_attention_plain(q, k, v, True)
        err = check_close(f"K4 bf16_probs {shape} {dtype}", out, ref, 1e-2, 1e-2)
        del out, ref
        b, h, s, d = shape
        row = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": err}
        row["rounding"] = check_rounding(f"K4 bf16_probs {shape} {dtype}",
                                         streaming_self_attention, shape, dtype, gen,
                                         K4_SUM_TILE[dtype])
        torch.cuda.empty_cache()
        if shape == K4_768:
            main_err = err
            row["launches_sd15_768_pair"] = 1
        _mode_row(row, lambda: streaming_self_attention(q, k, v, True),
                  lambda: streaming_self_attention_plain(q, k, v, True),
                  4 * b * h * s * s * d, 4 * b * h * s * d * q.element_size(), exact=(q, k, v),
                  dtype=dtype, exps=b * h * s * s, plain_reps=5,
                  # float32: Q K^T in 3 TF32 products, P V (P exact in TF32) in 2
                  tf32_passes=2.5 if dtype == torch.float32 else 0.0)
        rows.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    return {"rows": rows, "max_abs_err": main_err}


# K4 past D = 512 (csrc/streaming_attention_wide.cu): the mid attention of a 1024 px encode of two
# images by a VAE whose last block is 1024 (768) wide
K4_WIDE = ((2, 1, 16384, 1024), (2, 1, 16384, 768))
K4_WIDE_SWEEP = (520, 576, 640, 768, 896, 1024)  # head dims past 512 at S = 8192, both dtypes
K4_F32_RAGGED = (168, 200, 328)  # float32 head dims that are not multiples of 64, S = 8192
K4_PADDED = (170, 1020)  # head dims that are not multiples of 8, S = 8192: zero-padded to 176, 1024
# more B*H rows than a CUDA grid's y axis takes: the wide library in one launch (float32 at D 200),
# the D <= 512 one in two (65535 rows, then 1). Over 64 keys the outputs are O(1), so bf16 is held
# at the sharp-logit limit, atol = rtol = 1e-2 (one bf16 ulp of an output in [1, 2) is 7.8e-3)
K4_MANY_HEADS = (((65536, 1, 64, 200), torch.float32, 1), ((65536, 1, 64, 256), torch.bfloat16, 2))
# (d, dtype) of the wide library's kernels whose cluster occupancy the phase prints
K4_CLUSTER_KERNELS = ((1024, torch.float32), (768, torch.float32), (200, torch.float32),
                      (1024, torch.bfloat16), (768, torch.bfloat16))
VAE_WIDE = VAEConfig(block_out_channels=(128, 256, 512, 1024))
VAE_WIDE_IMAGES = 2
# the widened encoder's moments against the same encode with the plain K4, |d| / |plain|: in
# float32 the kernel's own limit (1e-5), with TF32 off (cuDNN's TF32 convolutions round their
# inputs to 10 bits, so a rounding difference at the mid attention flips roundings after it,
# each 2^-11 relative); in bf16 the --xl_vae_bf16 check's
VAE_WIDE_MOMENTS_TOL = {torch.float32: 1e-5, torch.bfloat16: XL_BF16_MOMENTS_TOL}
VAE_WIDE_PER = (f"one encode of {VAE_WIDE_IMAGES} images at 1024 px by the VAE encoder with "
                f"block_out_channels {VAE_WIDE.block_out_channels}")


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def k4_wide_clusters() -> dict:
    """The 2-block clusters of each wide kernel that the card runs at once, at its shared memory
    (``cudaOccupancyMaxActiveClusters``); fails if any kernel fits none."""
    lib = build.library("streaming_attention_wide")
    fn = lib.streaming_attention_wide_clusters
    fn.argtypes, fn.restype = [_I, _I, _I, ctypes.POINTER(ctypes.c_int)], _I
    pairs = {}
    for d, dtype in K4_CLUSTER_KERNELS:
        for mode in (0, 1):
            n = ctypes.c_int(0)
            build.check(lib, fn(d, kattn._DTYPES[dtype], mode, ctypes.byref(n)),
                        "streaming_attention_wide_clusters")
            pairs[f"{_dtype_name(dtype)} D {d}{' bf16_probs' if mode else ''}"] = n.value
    print(f"  pairs (2-block clusters) the card runs at once, by cudaOccupancyMaxActiveClusters: "
          f"{pairs}", flush=True)
    if min(pairs.values()) < 1:
        raise SystemExit(f"a wide K4 kernel's cluster fits nowhere on the card: {pairs}")
    return pairs


def k4_wide_edges(gen) -> dict:
    """K4's wrapper at the shapes its kernels take only through it: D % 8 != 0 (zero-padded, the
    output sliced back) in both dtypes, and more B*H rows than a grid's y axis takes (the wide
    library in one launch, the D <= 512 one in a launch a slice), against the plain version."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = (1e-5, 0.0) if dtype == torch.float32 else K4_BF16_TOL
        for d in K4_PADDED:
            shape = (1, 1, 8192, d)
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            out = streaming_self_attention(q, k, v)
            torch.cuda.synchronize()
            if out.shape != shape or not out.is_contiguous():
                raise SystemExit(f"K4 {shape}: the padded call gave {tuple(out.shape)}")
            errs[f"{_dtype_name(dtype)} D {d}"] = check_close(
                f"K4 {shape} {_dtype_name(dtype)} (padded to {d + -d % 8})", out,
                streaming_self_attention_plain(q, k, v), *tol)
            del q, k, v, out
    for shape, dtype, launches in K4_MANY_HEADS:
        tol = (1e-5, 0.0) if dtype == torch.float32 else K4_SHARP_TOL
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
        before = streaming_self_attention.launches
        out = streaming_self_attention(q, k, v)
        torch.cuda.synchronize()
        took = streaming_self_attention.launches - before
        name = f"K4 {shape} {_dtype_name(dtype)} (B*H > 65535, {took} launch(es))"
        errs[f"{_dtype_name(dtype)} B*H {shape[0] * shape[1]}"] = check_close(
            name, out, streaming_self_attention_plain(q, k, v), *tol)
        if took != launches:
            raise SystemExit(f"{name}: expected {launches} launch(es)")
        del q, k, v, out
        torch.cuda.empty_cache()
    return errs


def k4_wide_phase(gen) -> dict:
    phase(f"K4 wide heads (csrc/streaming_attention_wide.cu, 2-block clusters) vs plain: 512 < D "
          f"<= 1024 and float32 at D % 64 != 0 (float32 atol 1e-5; bf16 atol {K4_BF16_TOL[0]}, "
          f"rtol {K4_BF16_TOL[1]}; the bf16_probs mode atol=rtol=1e-2 and vs the kernels' own "
          "rounding), timed beside the previous design (v1, held to the plain version too) and "
          "SDPA, the bf16_probs mode timed too; a D sweep at S = 8192; sharp logits with a "
          "control; D % 8 != 0 and B*H > 65535 through the wrapper")
    clusters = k4_wide_clusters()
    rows = []
    errs = {"float32": 0.0, "bfloat16": 0.0}
    for shape in K4_WIDE:
        for dtype in (torch.float32, torch.bfloat16):
            name = _dtype_name(dtype)
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            out = streaming_self_attention(q, k, v)
            torch.cuda.synchronize()
            ref = streaming_self_attention_plain(q, k, v)
            tol = (1e-5, 0.0) if dtype == torch.float32 else K4_BF16_TOL
            err = check_close(f"K4 wide {shape} {name}", out, ref, *tol)
            del out

            def v1(q=q, k=k, v=v, code=kattn._DTYPES[dtype]):
                return v2_kernel("streaming_attention_wide_v1_fwd", q, k, v, code, 0)

            v1_err = check_close(f"K4 wide v1 {shape} {name}", v1(), ref, *tol, quiet=True)
            del ref
            fast = streaming_self_attention(q, k, v, True)
            torch.cuda.synchronize()
            fast_err = check_close(f"K4 wide bf16_probs {shape} {name}", fast,
                                   streaming_self_attention_plain(q, k, v, True), 1e-2, 1e-2)
            del fast
            errs[name] = max(errs[name], err)
            row = {"shape": list(shape), "dtype": name, "max_abs_err": err,
                   "bf16_probs_max_abs_err": fast_err, "v1_max_abs_err": v1_err}
            row["rounding"] = check_rounding(f"K4 wide bf16_probs {shape} {name}",
                                             streaming_self_attention, shape, dtype, gen,
                                             K4_SUM_TILE[dtype])
            torch.cuda.empty_cache()
            b, h, s, d = shape
            _timed(row, lambda: streaming_self_attention(q, k, v),
                   lambda: streaming_self_attention_plain(q, k, v),
                   4 * b * h * s * s * d, 4 * b * h * s * d * q.element_size(),
                   library=lambda: F.scaled_dot_product_attention(q, k, v), v2=v1, dtype=dtype,
                   plain_reps=5, exps=b * h * s * s,
                   tf32_passes=3.0 if dtype == torch.float32 else 0.0,
                   info={"bf16_probs_ms": lambda: streaming_self_attention(q, k, v, True)})
            if not row["ms"] < row["v2_ms"]:
                raise SystemExit(f"K4 wide {shape} {name}: the cluster design ({row['ms']:.3f} "
                                 f"ms) is not faster than its previous design ({row['v2_ms']:.3f})")
            rows.append(row)
            del q, k, v
            torch.cuda.empty_cache()
    sweep = []
    for dtype in (torch.float32, torch.bfloat16):
        dims = K4_F32_RAGGED + K4_WIDE_SWEEP if dtype == torch.float32 else K4_WIDE_SWEEP
        for d in dims:
            shape = (1, 1, 8192, d)
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            out = streaming_self_attention(q, k, v)
            torch.cuda.synchronize()
            tol = (1e-5, 0.0) if dtype == torch.float32 else K4_BF16_TOL
            err = check_close(f"K4 wide {shape} {_dtype_name(dtype)} (sweep)", out,
                              streaming_self_attention_plain(q, k, v), *tol)
            errs[_dtype_name(dtype)] = max(errs[_dtype_name(dtype)], err)
            sweep.append({"shape": list(shape), "dtype": _dtype_name(dtype), "max_abs_err": err})
            del q, k, v, out
    sharp = k4_sharp_check((1, 1, 8192, 1024), gen)
    edges = k4_wide_edges(gen)
    torch.cuda.empty_cache()
    vae = k4_wide_vae(gen)
    for row in rows:  # the encode's launches, on the row of its attention's shape
        if tuple(row["shape"]) == (VAE_WIDE_IMAGES, 1, 16384, VAE_WIDE.block_out_channels[-1]):
            row["launches_vae_wide_encode"] = vae[row["dtype"]]["launches"]
    return {"rows": rows, "max_abs_err": errs, "sweep": sweep, "sharp": sharp, "vae": vae,
            "clusters": clusters, "edges": edges}


def k4_wide_vae(gen) -> dict:
    """The widened VAE encoder at 1024 px, random weights from ``gen``, in float32 and bf16: the
    encode's launches (every count set to 0 just before it), its moments against the same
    encode with the plain K4 and with the control, V in place of the attention, and its time."""
    phase(f"K4 wide heads through the VAE encoder with block_out_channels "
          f"{VAE_WIDE.block_out_channels} at 1024 px, {VAE_WIDE_IMAGES} images, float32 and "
          "bf16: 1 K4 launch a chunk at (2, 1, 16384, 1024); the moments held to the same encode "
          "with the plain K4 (|d| / |plain| <= 1e-5 float32 with TF32 off, 1e-2 bf16), a "
          "control (V in place of the attention) that must fail the limit")
    from diffsim_tpu_torch.ops import attention as ops_attention

    kernel = ops_attention.streaming_self_attention
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = _dtype_name(dtype)
        enc = build_module(lambda: Encoder(VAE_WIDE), None, "vae", torch.device("cuda"), dtype,
                           gen)
        x = (torch.rand((VAE_WIDE_IMAGES, 3, 1024, 1024), generator=gen, device="cuda") * 2
             - 1).to(dtype)
        chunks = -(-VAE_WIDE_IMAGES // default_chunk(x))

        def moments() -> torch.Tensor:
            with torch.inference_mode():
                return encode_chunked(enc, x).float()

        with tf32_off() if dtype == torch.float32 else contextlib.nullcontext():
            kernels.reset_launch_counts()
            z = moments()
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            f32_counts = kernels.float32_launch_counts()
            expected = {**NONE, "streaming_self_attention": chunks}
            f32_expected = chunks if dtype == torch.float32 else 0
            print(f"  {name} encode: {chunks} chunk(s) of {default_chunk(x)} images, launches "
                  f"{counts} (float32 {f32_counts['streaming_self_attention']})", flush=True)
            if counts != expected or f32_counts["streaming_self_attention"] != f32_expected:
                raise SystemExit(f"the widened VAE encode launched {counts} (float32 "
                                 f"{f32_counts}), not {expected}")
            if z.shape != (VAE_WIDE_IMAGES, 8, 128, 128) or not torch.isfinite(z).all():
                raise SystemExit(f"the widened VAE encode gave {tuple(z.shape)} moments or "
                                 "non-finite values")
            gaps = {}
            for what, attn in (
                    ("the plain K4",
                     lambda q, k, v, bf16_probs=False: streaming_self_attention_plain(
                         q, k, v, bf16_probs)),
                    ("the control, V", lambda q, k, v, bf16_probs=False: v)):
                ops_attention.streaming_self_attention = attn
                try:
                    zp = moments()
                finally:
                    ops_attention.streaming_self_attention = kernel
                gaps[what] = ((z - zp).norm() / zp.norm()).item()
        lim = VAE_WIDE_MOMENTS_TOL[dtype]
        gap, ctl_gap = gaps.values()
        ok = gap <= lim and ctl_gap > lim
        print(f"  {name} moments |d| / |plain K4| = {gap:.3e} (limit {lim:g}); control, V: "
              f"{ctl_gap:.3e} ({'fails the limit' if ctl_gap > lim else 'within the limit'}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"the widened VAE encode in {name}: moments {gap:.3e} off the plain "
                             f"K4's (control {ctl_gap:.3e}, limit {lim:g})")
        encode_ms = time_ms(moments, reps=3, warmup=1)
        print(f"  {name} encode {encode_ms:.1f} ms with the default TF32 settings (CUDA events, "
              "median of 3)", flush=True)
        out[name] = {"launches": counts["streaming_self_attention"], "chunks": chunks,
                     "moments_gap": gap, "control_moments_gap": ctl_gap, "limit": lim,
                     "encode_ms": encode_ms}
        del enc, x, z, zp
        torch.cuda.empty_cache()
    return out


def k4_wide_entries(k4_wide: dict) -> list[dict]:
    """K4's wide rows, one entry a dtype: launches and totals over one widened VAE encode."""
    entries = []
    for name, design in (("float32", K4_WIDE_DESIGN), ("bfloat16", K4_WIDE_BF16_DESIGN)):
        result = {"rows": [r for r in k4_wide["rows"] if r["dtype"] == name],
                  "max_abs_err": k4_wide["max_abs_err"][name]}
        entry = kernel_entry(f"streaming_self_attention (wide, {name})",
                             "diffsim_tpu_torch/csrc/streaming_attention_wide.cu",
                             "diffsim_tpu/ops/pallas/attention_stream.py:94", design, result,
                             (k4_wide["vae"][name]["launches"], "launches_vae_wide_encode",
                              VAE_WIDE_PER))
        entry["vae_encode"] = k4_wide["vae"][name]
        entry["sweep"] = [r for r in k4_wide["sweep"] if r["dtype"] == name]
        entry["clusters_at_once"] = {key: n for key, n in k4_wide["clusters"].items()
                                     if key.startswith(name)}
        entry["edges"] = {key: err for key, err in k4_wide["edges"].items()
                          if key.startswith(name)}
        if name == "bfloat16":
            entry["sharp_logits"] = k4_wide["sharp"]
        entries.append(entry)
    return entries


def guard_slope(name: str, scorer, args, counts, img: int, card_line: str) -> dict:
    """Calibrate the device-memory guard on ``scorer``: the peak of
    ``torch.cuda.max_memory_allocated`` of the fresh triplet path at two triplet counts (each
    after a warm-up call), the peak of one VAE encode slice, and the bytes the scoring tail
    alone adds per triplet (all-hit ``score_triplet_paths`` calls over three images, whose peak
    above the memory already held is the tail's). ``main`` fails unless the guard's
    per-triplet constant is at least the tail's slope, its encode constant at least the slice's
    peak, and its estimate at least each measured peak of the fresh path."""
    from PIL import Image

    rng = np.random.default_rng(3)
    lo, hi = counts
    peaks = {}
    for t in counts:
        pix = [rng.integers(0, 256, (t, img, img, 3), dtype=np.uint8) for _ in range(3)]
        scorer.score_triplet_batch(*pix, **args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        scorer.score_triplet_batch(*pix, **args)
        torch.cuda.synchronize()
        peaks[t] = torch.cuda.max_memory_allocated()
        del pix
    per = hbm_guard.per_triplet_bytes(scorer)
    est = {t: hbm_guard.scorer_static_bytes(scorer) + per * t for t in counts}

    def peak_above(fn) -> int:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    enc_dtype = getattr(scorer, "enc_dtype", scorer.dtype)
    n = max(1, 16 * 512 * 512 * 2 // (img * img * torch.empty((), dtype=enc_dtype).element_size()))
    pix = rng.integers(0, 256, (n, img, img, 3), dtype=np.uint8)
    with torch.inference_mode():
        encode = peak_above(lambda: scorer._encode([pix]))
    del pix
    tail = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"{i}.png") for i in range(3)]
        for path in paths:
            Image.fromarray(rng.integers(0, 256, (img, img, 3), dtype=np.uint8)).save(path)
        for t in counts:
            roles = [[path] * t for path in paths]
            scorer.score_triplet_paths(*roles, **args)  # the misses, and a warm-up
            tail[t] = peak_above(lambda: scorer.score_triplet_paths(*roles, **args))
    slope = (tail[hi] - tail[lo]) / (hi - lo)
    print(f"  {name} device-memory guard on {card_line}: the fresh path peaks at "
          f"{peaks[lo] / 1e9:.3f} GB with {lo} triplets and {peaks[hi] / 1e9:.3f} GB with {hi} "
          f"(the guard's estimates {est[lo] / 1e9:.3f} and {est[hi] / 1e9:.3f}); one {n}-image "
          f"encode slice {encode / 1e9:.3f} GB (the guard's {hbm_guard.ENCODE_BYTES / 1e9:.3f}); "
          f"the scoring tail {tail[lo] / 1e9:.3f} GB at {lo} triplets and {tail[hi] / 1e9:.3f} at "
          f"{hi}: {slope / 1e9:.4f} GB per triplet (the guard's {per / 1e9:.3f}); budget "
          f"{hbm_guard.budget_bytes(scorer.device) / 1e9:.2f} GB: at most "
          f"{hbm_guard.max_triplets(scorer)} triplets a chunk; a 40-triplet call runs in chunks "
          f"of {resolve_cached_chunk(40, None, scorer)}", flush=True)
    return {"name": name, "slope": slope, "per_triplet": per, "encode_peak": encode,
            "encode_bytes": hbm_guard.ENCODE_BYTES, "peaks": peaks, "estimates": est,
            "tail": tail}


def pair_slope(name: str, scorer, args, counts, img: int, card_line: str) -> dict:
    """Calibrate the device-memory guard's pair path on ``scorer``: the peak of
    ``torch.cuda.max_memory_allocated`` of ``score_batch`` at two pair counts (each after a
    warm-up call, reset and read as in :func:`guard_slope`), and the peak of its tail, the part
    after the last VAE encode slice (the peak stats reset by a forward hook on the encoder at
    the end of each slice). At these counts the call's peak is the encode slice's, which does
    not grow with P, so the tail's slope is the one that tells. ``main`` fails unless the
    guard's per-pair estimate is at least both slopes and its estimate at each count at least
    the call's peak."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(4)
    lo, hi = counts
    peaks, tail = {}, {}
    readings = []

    def after_slice(*_):
        readings.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    for p in counts:
        pix = [rng.integers(0, 256, (p, img, img, 3), dtype=np.uint8) for _ in range(2)]
        scorer.score_batch(*pix, **args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        readings.clear()
        hook = scorer.vae.register_forward_hook(after_slice)
        try:
            scorer.score_batch(*pix, **args)
        finally:
            hook.remove()
        torch.cuda.synchronize()
        tail[p] = torch.cuda.max_memory_allocated()
        peaks[p] = max(readings + [tail[p]])
        del pix
    per = hbm_guard.per_pair_bytes(scorer)
    est = {p: hbm_guard.scorer_static_bytes(scorer) + per * p for p in counts}
    slope = (peaks[hi] - peaks[lo]) / (hi - lo)
    tail_slope = (tail[hi] - tail[lo]) / (hi - lo)
    took = time.perf_counter() - t0
    print(f"  {name} pair path, device-memory guard on {card_line}: score_batch peaks at "
          f"{peaks[lo] / 1e9:.3f} GB with {lo} pairs and {peaks[hi] / 1e9:.3f} GB with {hi} "
          f"(the guard's estimates {est[lo] / 1e9:.3f} and {est[hi] / 1e9:.3f}): "
          f"{slope / 1e9:.4f} GB per pair; after the encode {tail[lo] / 1e9:.3f} and "
          f"{tail[hi] / 1e9:.3f} GB: {tail_slope / 1e9:.4f} GB per pair (the guard's "
          f"{per / 1e9:.4f}); {took:.1f} s", flush=True)
    return {"name": name, "slope": slope, "tail_slope": tail_slope, "per_pair": per,
            "peaks": peaks, "tail": tail, "estimates": est, "seconds": took}


def pair_refusal(scorer, args, n: int, img: int, card_line: str) -> dict:
    """The guard's refusal on the card: with ``DIFFSIM_TPU_HBM_GB`` just below the estimate of
    ``n`` pairs, ``score_batch`` of ``n`` pairs must raise ``HbmBudgetError`` with
    ``torch.cuda.memory_allocated()`` unmoved (nothing uploaded), and ``n // 2`` pairs must
    then score."""
    rng = np.random.default_rng(6)
    pix = [rng.integers(0, 256, (n, img, img, 3), dtype=np.uint8) for _ in range(2)]
    est = hbm_guard.scorer_static_bytes(scorer) + hbm_guard.per_pair_bytes(scorer) * n
    budget_gb = est * (1 - 1e-6) / hbm_guard.MARGIN / 1e9
    kept = os.environ.get("DIFFSIM_TPU_HBM_GB")
    os.environ["DIFFSIM_TPU_HBM_GB"] = repr(budget_gb)
    try:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        try:
            scorer.score_batch(*pix, **args)
        except hbm_guard.HbmBudgetError as err:
            message = str(err)
        else:
            raise SystemExit(f"score_batch of {n} pairs ran under a budget below its estimate")
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        if after != before:
            raise SystemExit(f"a refused {n}-pair call moved the device memory from {before} "
                             f"to {after} bytes")
        half = scorer.score_batch(pix[0][:n // 2], pix[1][:n // 2], **args)
    finally:
        if kept is None:
            del os.environ["DIFFSIM_TPU_HBM_GB"]
        else:
            os.environ["DIFFSIM_TPU_HBM_GB"] = kept
    _check_scores(f"score_batch of {n // 2} pairs under the budget", half)
    print(f"  DIFFSIM_TPU_HBM_GB={budget_gb:.4f} on {card_line}: {n} pairs refused ({message}), "
          f"memory_allocated {before} bytes before and {after} after; {n // 2} pairs scored "
          f"{half}", flush=True)
    return {"pairs": n, "budget_gb": budget_gb, "estimate": est, "allocated_before": before,
            "allocated_after": after, "message": message}


def _cute_tree(root: str) -> str:
    """A CUTE-shaped tree of random 640 x 480 JPEGs from a seeded generator: 2 classes x 3
    level-2 dirs x 2 level-3 dirs x 3 images, the level-3 names repeated under every level-2
    dir (the layout of tests/fixtures.make_cute): 36 images, 60 comparisons."""
    from PIL import Image

    rng = np.random.default_rng(2334)
    base = os.path.join(root, "cute")
    for cls in ("cat", "mug"):
        for lvl2 in ("env_a", "env_b", "env_c"):
            for lvl3 in ("obj1", "obj2"):
                d = os.path.join(base, cls, lvl2, lvl3)
                os.makedirs(d)
                for i in range(3):
                    Image.fromarray(rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)).save(
                        os.path.join(d, f"im{i}.jpg"), quality=90)
    return base


def _cli_run(what: str, tree: str, out: str, *extra):
    """One ``run_benchmark("cute", --preset cute ...)`` on the card with the launch counts set to
    0 just before it; returns its report, adapter, {idx: (s_ab, s_ac)}, launch counts (all and
    bf16_probs) and wall time (scorer init included)."""
    argv = ["--preset", "cute", "--image_path", tree, "--batch_size", str(CLI_BATCH),
            "--results", out, *extra]
    print(f"  {what}: cute {' '.join(argv[2:])}", flush=True)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report, (adapter,) = run_benchmark("cute", argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, fast = kernels.launch_counts(), kernels.bf16_probs_launch_counts()
    with open(out) as f:
        recs = [json.loads(line) for line in f]
    scores = {r["idx"]: (r["s_ab"], r["s_ac"]) for r in recs}
    print(f"  {what}: {report.total} comparisons in {wall:.2f} s with the scorer's init, "
          f"{2 * report.total / wall:.2f} pairs/s (information only, not a benchmark); "
          f"launches {counts}, in the bf16_probs mode {fast}", flush=True)
    return report, adapter, scores, counts, fast, wall


def _scores_gap(a: dict, b: dict) -> float:
    return max(abs(x - y) for i in a for x, y in zip(a[i], b[i]))


def cli_phase(card_line: str, tree: str) -> dict:
    phase("the 2AFC CLI at full SD-1.5 width: cute --preset cute, 60 comparisons over 36 "
          "random JPEGs, through the device moment cache; --no_device_cache; an all-hit "
          "rescore; --bf16_softmax")
    with tempfile.TemporaryDirectory() as tmp:
        plan = benchmarks.cute(tree, 2334)
        images = {p for c in plan for p in (c.a, c.b, c.c)}
        if len(plan) != 60:
            raise SystemExit(f"the CUTE tree planned {len(plan)} comparisons, not 60")
        report, adapter, cached, counts, _, wall = _cli_run("cached", tree,
                                                            os.path.join(tmp, "cached.jsonl"),
                                                            "--profile")
        scorer = adapter.scorer
        stats = dict(scorer._moment_cache.stats)
        step = resolve_cached_chunk(CLI_BATCH, None, scorer)
        calls = sum(-(-len(plan[i:i + CLI_BATCH]) // step) for i in range(0, 60, CLI_BATCH))
        want = {**NONE, "fused_self_attention": 8 * calls, "fused_geglu_ff": 4 * calls}
        hit_rate = stats["hits"] / (stats["hits"] + stats["misses"])
        print(f"  moment cache {stats}: hit rate {hit_rate:.4f} over {3 * len(plan)} image "
              f"references to {len(images)} images; {calls} UNet forwards", flush=True)
        if report.total != 60 or sorted(cached) != list(range(60)):
            raise SystemExit(f"the CLI scored {report.total} of 60 comparisons")
        if stats["misses"] != len(images) or stats["hits"] != 3 * 60 - len(images):
            raise SystemExit("the moment cache did not take one miss per image")
        if counts != want:
            raise SystemExit(f"the CLI run launched {counts}, expected {want}")
        _check_scores("the CLI's scores", np.array(list(cached.values())))

        # an all-hit rescore through the same scorer, batch by batch as the runner called it
        t0 = time.perf_counter()
        again = {}
        for i in range(0, 60, CLI_BATCH):
            rows = plan[i:i + CLI_BATCH]
            s_ab, s_ac = adapter.score_triplet_paths(
                *([getattr(c, r) for c in rows] for r in "abc"), prompts=[c.prompt for c in rows])
            again.update({i + j: (float(x), float(y)) for j, (x, y) in enumerate(zip(s_ab, s_ac))})
        rescore_s = time.perf_counter() - t0
        if scorer._moment_cache.misses != stats["misses"] or again != cached:
            raise SystemExit("the all-hit rescore missed the cache or changed a score")
        print(f"  all-hit rescore: {rescore_s:.3f} s, {120 / rescore_s:.2f} pairs/s, scores "
              "bit for bit as the first run's", flush=True)
        del adapter, scorer
        torch.cuda.empty_cache()

        fresh_report, fresh_ad, fresh, fresh_counts, _, fresh_wall = _cli_run(
            "--no_device_cache", tree, os.path.join(tmp, "fresh.jsonl"), "--no_device_cache")
        gap = _scores_gap(cached, fresh)
        print(f"  cached vs --no_device_cache: max |d score| = {gap:.3e} (limit 1e-2)", flush=True)
        if fresh_counts != want or gap > 1e-2 or fresh_ad.scorer._moment_cache is not None:
            raise SystemExit("the fresh CLI run disagrees with the cached run")
        del fresh_ad
        torch.cuda.empty_cache()

        fast_report, fast_ad, fast, fast_counts, fast_modes, fast_wall = _cli_run(
            "--bf16_softmax", tree, os.path.join(tmp, "fast.jsonl"), "--bf16_softmax")
        fast_gap = _scores_gap(cached, fast)
        print(f"  --bf16_softmax vs exact: max |d score| = {fast_gap:.3e} (limit 0.05, and not "
              "0)", flush=True)
        k1 = want["fused_self_attention"]
        if (fast_counts != want or fast_modes["fused_self_attention"] != k1
                or not 0 < fast_gap <= 0.05):
            raise SystemExit("the --bf16_softmax CLI run did not take the mode or disagrees")
        del fast_ad
        torch.cuda.empty_cache()
    return {"counts": counts, "fast_counts": fast_modes, "forwards": calls, "step": step,
            "scores": cached, "hit_rate": hit_rate, "stats": stats,
            "pairs_per_s": {"cached": 120 / wall, "no_device_cache": 120 / fresh_wall,
                            "bf16_softmax": 120 / fast_wall, "all_hit_rescore": 120 / rescore_s},
            "cached_vs_fresh": gap, "fast_vs_exact": fast_gap}


def dit_cli_phase(tree: str) -> dict:
    phase("the 2AFC CLI with the DiT scorer at full DiT-XL/2 width, 512 px: cute --preset cute "
          "--metric dit, the same 60 comparisons over the 36 JPEGs, through the device moment "
          "cache")
    plan = benchmarks.cute(tree, 2334)
    images = {p for c in plan for p in (c.a, c.b, c.c)}
    with tempfile.TemporaryDirectory() as tmp:
        report, adapter, scores, counts, _, wall = _cli_run(
            "--metric dit", tree, os.path.join(tmp, "dit.jsonl"), "--metric", "dit")
    scorer = adapter.scorer
    stats = dict(scorer._moment_cache.stats)
    step = resolve_cached_chunk(CLI_BATCH, None, scorer)
    calls = sum(-(-len(plan[i:i + CLI_BATCH]) // step) for i in range(0, len(plan), CLI_BATCH))
    # the preset's tap is block 0: each forward stops at block 0's qkv, before any attention
    want = {**NONE, "cross_self_partials": 4 * calls}
    hit_rate = stats["hits"] / (stats["hits"] + stats["misses"])
    print(f"  moment cache {stats}: hit rate {hit_rate:.4f} over {3 * len(plan)} image "
          f"references to {len(images)} images; {calls} scoring calls", flush=True)
    if report.total != len(plan) or sorted(scores) != list(range(len(plan))):
        raise SystemExit(f"the DiT CLI run scored {report.total} of {len(plan)} comparisons")
    if stats["misses"] != len(images) or hit_rate < 0.8:
        raise SystemExit("the DiT CLI run did not take one miss per image")
    if counts != want:
        raise SystemExit(f"the DiT CLI run launched {counts}, expected {want}")
    _check_scores("the DiT CLI's scores", np.array(list(scores.values())))
    del adapter, scorer
    torch.cuda.empty_cache()
    return {"counts": counts, "calls": calls, "hit_rate": hit_rate, "stats": stats,
            "pairs_per_s": 2 * len(plan) / wall}


def surface_cli_phase(tree: str) -> dict:
    """The CLI's new paths at full SD-1.5 width over the 36 JPEGs, each on the pair path
    (one scoring call per batch of comparisons) with its exact launches."""
    phase("the 2AFC CLI at full SD-1.5 width on the pair path: cute --preset cute with "
          "--ip_adapter, --use_mask --mask_path, --use_mask (heuristic masks), --metric diffeats")
    from PIL import Image

    plan = benchmarks.cute(tree, 2334)
    calls = -(-len(plan) // CLI_BATCH)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        mask_root = os.path.join(tmp, "masks")
        rng = np.random.default_rng(9)
        for path in sorted({p for c in plan for p in (c.a, c.b, c.c)}):
            # each JPEG's mask is a PNG of its stem: mask_path_for's fallback
            dst = os.path.splitext(os.path.join(mask_root, os.path.relpath(path, tree)))[0]
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            Image.fromarray((_box_masks(rng, 1, 480)[0][0] * 255).astype(np.uint8)).save(
                dst + ".png")
        runs = {"cli_ip_adapter": (["--ip_adapter"], SD15_IP_CALL),
                "cli_mask_path": (["--use_mask", "--mask_path", mask_root], SD15_CALL),
                "cli_heuristic_masks": (["--use_mask"], SD15_CALL),
                "cli_diffeats": (["--metric", "diffeats"], SD15_IP_CALL)}
        for what, (extra, per_call) in runs.items():
            with warnings.catch_warnings():  # the heuristic's per-image inversion notices
                warnings.simplefilter("ignore", MattingInversionWarning)
                report, adapter, scores, counts, _, wall = _cli_run(
                    what, tree, os.path.join(tmp, f"{what}.jsonl"), *extra)
            want = {k: v * calls for k, v in {**NONE, **per_call}.items()}
            if report.total != len(plan) or sorted(scores) != list(range(len(plan))):
                raise SystemExit(f"{what}: scored {report.total} of {len(plan)} comparisons")
            if counts != want:
                raise SystemExit(f"{what}: launched {counts}, expected {want} ({calls} calls)")
            _check_scores(what, np.array(list(scores.values())))
            out[what] = {"counts": counts, "pairs_per_s": 2 * len(plan) / wall}
            del adapter
            torch.cuda.empty_cache()
    return out


def write_safetensors(path: str, tensors: dict) -> None:
    """A ``.safetensors`` file of float32 or bf16 CPU tensors, written byte by byte: an 8-byte
    little-endian header length, the JSON header (padded with spaces to 8 bytes), then the raw
    little-endian data, the layout ``convert/torch_import.load_safetensors`` reads."""
    header, chunks, offset = {}, [], 0
    for name, t in tensors.items():
        t = t.contiguous().cpu()
        if t.dtype == torch.bfloat16:
            kind, raw = "BF16", t.view(torch.int16).numpy().astype("<i2").tobytes()
        else:
            kind, raw = "F32", t.float().numpy().astype("<f4").tobytes()
        header[name] = {"dtype": kind, "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in chunks:
            f.write(raw)


def _draw(shapes: dict, gen) -> dict:
    """Seeded bf16 tensors N(0, 0.05) of ``shapes``; norm scales 1 + N(0, 0.05)."""
    out = {}
    for name, shape in shapes.items():
        t = torch.randn(shape, generator=gen) * 0.05
        if "norm" in name and name.endswith("weight"):
            t += 1.0
        out[name] = t.to(torch.bfloat16)
    return out


def published_dit_sd(cfg, gen) -> dict:
    """A state dict of ``cfg`` in the published DiT checkpoint's naming and layouts (the
    patch embedding a strided Conv2d kernel, OIHW)."""
    h, p = cfg.hidden, cfg.patch_size
    shapes = {"x_embedder.proj.weight": (h, cfg.in_channels, p, p), "x_embedder.proj.bias": (h,),
              "pos_embed": (1, cfg.tokens_per_side ** 2, h),
              "t_embedder.mlp.0.weight": (h, 256), "t_embedder.mlp.0.bias": (h,),
              "t_embedder.mlp.2.weight": (h, h), "t_embedder.mlp.2.bias": (h,),
              "y_embedder.embedding_table.weight": (cfg.num_classes + 1, h),
              "final_layer.adaLN_modulation.1.weight": (2 * h, h),
              "final_layer.adaLN_modulation.1.bias": (2 * h,),
              "final_layer.linear.weight": (p * p * cfg.out_channels, h),
              "final_layer.linear.bias": (p * p * cfg.out_channels,)}
    mlp = int(h * cfg.mlp_ratio)
    for i in range(cfg.depth):
        for name, (dout, din) in (("attn.qkv", (3 * h, h)), ("attn.proj", (h, h)),
                                  ("mlp.fc1", (mlp, h)), ("mlp.fc2", (h, mlp)),
                                  ("adaLN_modulation.1", (6 * h, h))):
            shapes[f"blocks.{i}.{name}.weight"] = (dout, din)
            shapes[f"blocks.{i}.{name}.bias"] = (dout,)
    return _draw(shapes, gen)


def published_vae_sd(cfg, gen) -> dict:
    """A state dict of the AutoencoderKL ``cfg`` (encoder and decoder) in diffusers naming."""
    shapes = {}

    def conv(name, cin, cout, k=3):
        shapes[f"{name}.weight"], shapes[f"{name}.bias"] = (cout, cin, k, k), (cout,)

    def norm(name, c):
        shapes[f"{name}.weight"], shapes[f"{name}.bias"] = (c,), (c,)

    def resnet(base, cin, cout):
        norm(f"{base}.norm1", cin)
        conv(f"{base}.conv1", cin, cout)
        norm(f"{base}.norm2", cout)
        conv(f"{base}.conv2", cout, cout)
        if cin != cout:
            conv(f"{base}.conv_shortcut", cin, cout, k=1)

    def mid(base, c):
        resnet(f"{base}.resnets.0", c, c)
        norm(f"{base}.attentions.0.group_norm", c)
        for name in ("to_q", "to_k", "to_v", "to_out.0"):
            shapes[f"{base}.attentions.0.{name}.weight"] = (c, c)
            shapes[f"{base}.attentions.0.{name}.bias"] = (c,)
        resnet(f"{base}.resnets.1", c, c)

    chans, n = cfg.block_out_channels, cfg.layers_per_block
    conv("encoder.conv_in", cfg.in_channels, chans[0])
    cin = chans[0]
    for i, cout in enumerate(chans):
        for j in range(n):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", cin if j == 0 else cout, cout)
        if i < len(chans) - 1:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", cout, cout)
        cin = cout
    mid("encoder.mid_block", chans[-1])
    norm("encoder.conv_norm_out", chans[-1])
    conv("encoder.conv_out", chans[-1], 2 * cfg.latent_channels)
    conv("quant_conv", 2 * cfg.latent_channels, 2 * cfg.latent_channels, k=1)
    conv("post_quant_conv", cfg.latent_channels, cfg.latent_channels, k=1)
    rev = list(reversed(chans))
    conv("decoder.conv_in", cfg.latent_channels, rev[0])
    mid("decoder.mid_block", rev[0])
    cin = rev[0]
    for i, cout in enumerate(rev):
        for j in range(n + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", cin if j == 0 else cout, cout)
        if i < len(rev) - 1:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", cout, cout)
        cin = cout
    norm("decoder.conv_norm_out", rev[-1])
    conv("decoder.conv_out", rev[-1], cfg.in_channels)
    return _draw(shapes, gen)


# the converter must run without these: each is made to raise on import in its process
NOT_NEEDED = ("jax", "safetensors", "ml_dtypes")
CONVERT_CLI = ("import runpy, sys\n"
               f"for name in {NOT_NEEDED!r}:\n"
               "    sys.modules[name] = None\n"
               "runpy.run_module('diffsim_tpu_torch.cli.convert', run_name='__main__', "
               "alter_sys=True)\n")


def convert_phase() -> dict:
    phase("the checkpoint converter on this machine: the convert CLI (python -m "
          "diffsim_tpu_torch.cli.convert dit, with jax, safetensors and ml_dtypes made to raise "
          "on import) on a train-format torch.save checkpoint ({'ema': ...}) of DiT-XL/2's "
          "widths cut to one block (256 px) with an SD-layout VAE of width 32 in a BF16 "
          "safetensors file written here, and on the same DiT as a safetensors file; the .npz "
          "through the --weights reader into a DiffSimDiT of that shape on the card")
    import importlib.util

    installed = [m for m in NOT_NEEDED if importlib.util.find_spec(m) is not None]
    print(f"  of {NOT_NEEDED}, installed here: {installed}; blocked in the converter's process",
          flush=True)
    gen = torch.Generator().manual_seed(2337)
    cfg = DiTConfig(input_size=32, depth=1)  # DiT-XL/2's widths at 256 px, one block
    vcfg = VAEConfig(block_out_channels=(32, 32, 32, 32))  # the SD VAE's four levels, width 32
    dit_sd, vae_sd = published_dit_sd(cfg, gen), published_vae_sd(vcfg, gen)
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, ckpt_st, vae_st = (os.path.join(tmp, f) for f in
                                 ("dit.pt", "dit.safetensors", "vae.safetensors"))
        torch.save({"ema": dit_sd, "opt": {}}, ckpt)
        write_safetensors(ckpt_st, dit_sd)
        write_safetensors(vae_st, vae_sd)
        outs = {}
        for what, path, extra in (("pt", ckpt, ["--vae", vae_st]), ("safetensors", ckpt_st, [])):
            outs[what] = os.path.join(tmp, f"{what}.npz")
            cmd = [sys.executable, "-c", CONVERT_CLI, "dit", "--ckpt", path,
                   "--image_size", "256", "--out", outs[what], *extra]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600)
            print(f"  convert dit --ckpt {os.path.basename(path)} {' '.join(extra[:1])}: rc "
                  f"{res.returncode} in {time.perf_counter() - t0:.1f} s: {res.stdout.strip()}",
                  flush=True)
            if res.returncode:
                print(res.stderr[-4000:], flush=True)
                raise SystemExit("the convert CLI failed on this machine")
        with np.load(outs["pt"]) as a, np.load(outs["safetensors"]) as b:
            keys = sorted(k for k in a.files if k.startswith("dit/"))
            roots = sorted({k.split("/")[0] for k in a.files})
            if (roots != ["dit", "vae", "vae_decoder"] or keys != sorted(b.files)
                    or any(a[k].dtype != np.dtype("V2") or a[k].tobytes() != b[k].tobytes()
                           for k in keys)):
                raise SystemExit("the two checkpoints' .npz files differ, or are not bf16")
        tree = registry._load_params(outs["pt"])  # the --weights reader
        scorer = DiffSimDiT(tree, dit_cfg=cfg, vae_cfg=vcfg, img_size=256)
        h, p = cfg.hidden, cfg.patch_size
        patch = dit_sd["x_embedder.proj.weight"].permute(0, 2, 3, 1).reshape(h, p * p * 4)
        pairs = ((scorer.dit.blocks[0].attn.qkv.weight, dit_sd["blocks.0.attn.qkv.weight"]),
                 (scorer.dit.patch_embed.weight, patch),
                 (scorer.dit.y_embedder, dit_sd["y_embedder.embedding_table.weight"]),
                 (scorer.vae.conv_in.weight, vae_sd["encoder.conv_in.weight"]))
        if not all(torch.equal(ours.cpu(), ref) for ours, ref in pairs):
            raise SystemExit("the converted weights on the card differ from the checkpoint's")
        rng = np.random.default_rng(6)
        pix = [rng.integers(0, 256, (2, 256, 256, 3), dtype=np.uint8) for _ in range(2)]
        scores = scorer.score_batch(*pix, target_layer=0, target_step=600)
    _check_scores("the converted DiT's scores", scores)
    print(f"  the converted DiT (1 block, {len(keys)} DiT leaves) on the card: scores {scores}; "
          "its weights equal the checkpoint's, the patch embedding in (ph, pw, C) order",
          flush=True)
    return {"installed_but_blocked": installed, "scores": scores.tolist()}


# ---------------------------------------------------------------------------
# the baseline metrics: CLIP, DINO, LPIPS, VGG-Gram, FFA with U^2-Net, the ensemble
# ---------------------------------------------------------------------------

BASELINE_PAIRS = 16
TINY_TEXT = CLIPTextConfig(vocab_size=1000, hidden=32, layers=2, heads=2, intermediate=64,
                           projection_dim=16)  # with a projection: clip_t reads it
FFA_TINY = dataclasses.replace(DinoConfig.tiny(), patch=14)  # the 24 x 24 grid at 336 px


def _he_convs(tree):
    """A tree with every convolution kernel (HWIO) redrawn at He's scale, sqrt(2 / fan-in), from
    its N(0, 0.1) draw, so that deep random conv stacks keep their activations' scale."""
    if isinstance(tree, dict):
        return {k: _he_convs(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_he_convs(v) for v in tree]
    if tree.ndim == 4:
        return tree * (np.sqrt(2.0 / np.prod(tree.shape[:3])) / 0.1)
    return tree


def _tiny_baselines(device: str, trees: dict) -> dict:
    """The tiny baseline scorers on ``device``, float32, on the same seeded trees."""
    return {"clip": CLIPScore(trees["clip"], vision_cfg=CLIPVisionConfig.tiny(),
                              text_cfg=TINY_TEXT, tokenizer=HashTokenizer(1000), device=device),
            "dino": Dinov2Score(trees["dino"], cfg=DinoConfig.tiny(), device=device),
            "dinov1": DinoScore(trees["dinov1"], cfg=DinoConfig.tiny(layerscale=False),
                                device=device),
            "lpips": LPIPS(trees["lpips"], device=device),
            "gram": VGGGram(trees["vgg"], device=device),
            "ffa": ForegroundFeatureAveraging(trees["ffa"], cfg=FFA_TINY, device=device),
            "u2net": U2NetMatting(trees["u2net"], U2NetConfig.tiny(), device=device)}


def tiny_baselines_phase() -> dict:
    phase("end to end, the baseline metrics at tiny width in float32: card vs CPU on the same "
          "bridged weights (|dscore| <= 1e-4), no K1-K4 launch; U^2-Net's saliency within 1e-4 "
          "and its matte's flipped pixels all within 1e-4 of the cut")
    rng = np.random.default_rng(2338)
    trees = {"clip": _random_tree(lambda: CLIPPair(CLIPVisionConfig.tiny(), TINY_TEXT), "clip",
                                  rng),
             "dino": _random_tree(lambda: Dino(DinoConfig.tiny()), "dino", rng),
             "dinov1": _random_tree(lambda: Dino(DinoConfig.tiny(layerscale=False)), "dino",
                                    rng),
             "ffa": _random_tree(lambda: Dino(FFA_TINY), "dino", rng),
             "lpips": _he_convs(_random_tree(LPIPSNet, "lpips", rng)),
             "vgg": _he_convs(_random_tree(lambda: VGG(VGG19_CFG), "vgg", rng)),
             "u2net": _he_convs(_random_tree(lambda: U2Net(U2NetConfig.tiny()), "u2net", rng))}
    clip_pix = [rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8) for _ in range(2)]
    dino_pix = [rng.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8) for _ in range(2)]
    lpips_pix = [rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8) for _ in range(2)]
    # two aspect ratios in one ragged batch: 48 x 64 and 64 x 64
    gram_pix = [[rng.integers(0, 256, (1, h, 64, 3), dtype=np.uint8) for h in (48, 64, 48)]
                for _ in range(2)]
    texts = ["a cat", "a mug on a table", "two dogs", "a red car"]
    images = [_salient_image(rng) for _ in range(4)]
    calls = {
        "clip_i": lambda s: s["clip"].clipi_score_batch(*clip_pix),
        "clipt": lambda s: s["clip"].clipt_score_batch(texts, clip_pix[0]),
        "clip_cross": lambda s: s["clip"].clip_cross_score_batch(*clip_pix, [1]),
        "clipfeats": lambda s: s["clip"].clip_feature_score_batch(*clip_pix, 0),
        "dino": lambda s: s["dino"].dino_score_batch(*dino_pix),
        "dinov1": lambda s: s["dinov1"].dino_score_batch(*dino_pix),
        "dino_cross": lambda s: s["dino"].dino_cross_score_batch(*dino_pix, 1),
        "dinofeats": lambda s: s["dino"].dino_feature_score_batch(*dino_pix, 0),
        "lpips": lambda s: s["lpips"].score_batch(*lpips_pix),
        "gram": lambda s: s["gram"].score_batch(*gram_pix),
    }
    out = {}
    with tf32_off():
        scorers = {d: _tiny_baselines(d, trees) for d in ("cuda", "cpu")}
        # U^2-Net: the saliency, then the matte; the cute metric scores the CPU's mattes on both
        sal = {d: np.stack([scorers[d]["u2net"].saliency(im) for im in images])
               for d in scorers}
        sal_gap = float(np.abs(sal["cuda"] - sal["cpu"]).max())
        flipped = (sal["cuda"] >= 0.5) != (sal["cpu"] >= 0.5)
        near = np.abs(sal["cpu"] - 0.5) <= 1e-4
        print(f"  U^2-Net saliency (tiny, 320 px): card vs CPU max|d| = {sal_gap:.3e} (limit "
              f"1e-4); matte pixels flipped {int(flipped.sum())} of {flipped.size}, all within "
              f"1e-4 of the cut: {bool((near | ~flipped).all())}", flush=True)
        if sal_gap > 1e-4 or (flipped & ~near).any():
            raise SystemExit("tiny U^2-Net: the card disagrees with the CPU")
        ffa_cpu = scorers["cpu"]["ffa"]
        ffa_cpu.matting = scorers["cpu"]["u2net"]
        rgba = [np.concatenate([ffa_cpu.preprocess(im) for im in images[i::2]]) for i in (0, 1)]
        calls["cute"] = lambda s: s["ffa"].score_batch("Crop-Feat", *rgba)
        for name, fn in calls.items():
            got = {}
            for device in ("cuda", "cpu"):
                if device == "cuda":
                    got[device], _ = _checked_call(f"tiny {name} on the card",
                                                   lambda: fn(scorers["cuda"]), {})
                else:
                    got[device] = fn(scorers["cpu"])
            gap = float(np.abs(got["cuda"] - got["cpu"]).max())
            print(f"  {name}: card {got['cuda']}, cpu {got['cpu']}, max|d| = {gap:.3e}",
                  flush=True)
            if not (np.isfinite(got["cuda"]).all() and gap <= 1e-4):
                raise SystemExit(f"tiny {name}: the card disagrees with the CPU")
            out[name] = gap
    out["u2net_saliency"] = sal_gap
    del scorers
    torch.cuda.empty_cache()
    return out


def _salient_image(rng, size=(320, 240)) -> "Image.Image":
    """A bright ellipse on a darker noisy ground, at a seeded place."""
    from PIL import Image

    w, h = size
    yy, xx = np.mgrid[:h, :w]
    cy, cx = rng.uniform(0.35, 0.65) * h, rng.uniform(0.35, 0.65) * w
    inside = ((yy - cy) / (h / 4)) ** 2 + ((xx - cx) / (w / 5)) ** 2 < 1
    img = rng.integers(10, 90, (h, w, 3)).astype(np.uint8)
    img[inside] = rng.integers(170, 256, (int(inside.sum()), 3))
    return Image.fromarray(img)


def _baseline_call(name: str, fn, card_line: str, check=None) -> dict:
    """One full-width baseline call: no K1-K4 launch, finite scores (and ``check``), a repeat
    bit for bit; its time (median of 5 by CUDA events, host work in) and peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    scores, _ = _checked_call(name, fn, {})
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not np.isfinite(scores).all() or (check is not None and not check(scores)):
        raise SystemExit(f"{name}: scores out of range: {scores}")
    if not np.array_equal(fn(), scores):
        raise SystemExit(f"{name}: a repeat call gave other scores")
    ms = time_ms(fn, reps=5, warmup=1)
    print(f"  {name}: {ms:.2f} ms a call of {len(scores)} pairs ({len(scores) / ms * 1e3:.1f} "
          f"pairs/s), peak device memory {peak:.2f} GiB, a repeat bit for bit; scores "
          f"{np.round(scores[:4], 5)} ... on {card_line} (information only)", flush=True)
    return {"call_ms": ms, "peak_gib": peak}


def _hundred_cos(s):
    return (np.abs(s) <= 100.0 + 1e-3).all()


def _cos(s):
    return (np.abs(s) <= 1.0 + 1e-6).all()


def baselines_phase(card_line: str, u2net_tree) -> dict:
    """The baseline metrics at their published widths on the card, random weights from seeded
    generators (float32; PyTorch's defaults, so cuDNN may run the convolutions in TF32), 16
    pairs each; a profile of the slowest call."""
    n = BASELINE_PAIRS
    rng = np.random.default_rng(2339)
    out, fns = {}, {}

    def pix(h, w=None):
        return [rng.integers(0, 256, (n, h, w or h, 3), dtype=np.uint8) for _ in range(2)]

    def run(name, label, fn, check):
        fns[name] = fn
        out[name] = _baseline_call(label, fn, card_line, check)

    phase(f"baselines at full width: CLIP ViT-B/32 at 224 px with the 512-wide text tower, {n} "
          "pairs (50 tokens: the math path)")
    clip = CLIPScore()
    p224 = pix(224)
    texts = [f"a photo of object {i}" for i in range(n)]
    run("clip_i", "clip_i", lambda: clip.clipi_score_batch(*p224), _hundred_cos)
    run("clip_t", "clip_t", lambda: clip.clipt_score_batch(texts, p224[0]), _hundred_cos)
    run("clip_cross", "clip_cross (layer 11)",
        lambda: clip.clip_cross_score_batch(*p224, -1), _cos)
    run("clipfeats", "clipfeats (layer 11)",
        lambda: clip.clip_feature_score_batch(*p224, -1), _cos)
    phase(f"baselines at full width: DINOv2-small at 224 px (257 tokens) and DINO v1 ViT-S/8 at "
          f"224 px (785 tokens), {n} pairs")
    dino, dinov1 = Dinov2Score(), DinoScore()
    run("dino", "dino", lambda: dino.dino_score_batch(*p224), _hundred_cos)
    run("dino_cross", "dino_cross (layer 11)", lambda: dino.dino_cross_score_batch(*p224, -1),
        _cos)
    run("dinofeats", "dinofeats (layer 11)", lambda: dino.dino_feature_score_batch(*p224, -1),
        _cos)
    run("dinov1", "dinov1", lambda: dinov1.dino_score_batch(*p224), _hundred_cos)
    run("dinov1_cross", "dino_cross on DINO v1 (layer 11, 785 tokens)",
        lambda: dinov1.dino_cross_score_batch(*p224, -1), _cos)
    phase(f"baselines at full width: LPIPS (VGG-16) at 512 px, and VGG-19 Gram at 512 px "
          f"shortest side (683 x 512 and 512 x 512 buckets in one ragged batch), {n} pairs")
    lpips, gram = LPIPS(), VGGGram()
    p512, wide = pix(512), pix(512, 683)
    ragged = [[(sq if i % 2 else wd)[i:i + 1] for i in range(n)] for sq, wd in zip(p512, wide)]
    run("lpips", "lpips", lambda: lpips.score_batch(*p512), lambda s: (s >= 0).all())
    run("gram", f"gram (ragged: {n // 2} of 683 x 512, {n - n // 2} of 512 x 512)",
        lambda: gram.score_batch(*ragged), _cos)
    phase(f"baselines at full width: FFA (cute) with DINOv2-base at 336 px (577 tokens) and "
          f"U^2-Netp at 320 px (the converter's .npz of a seeded checkpoint), {n} pairs of "
          "random 640 x 480 images with a salient blob")
    ffa = ForegroundFeatureAveraging(matting=U2NetMatting(u2net_tree))
    images = [_salient_image(rng, (640, 480)) for _ in range(2 * n)]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rgba = [np.concatenate([ffa.preprocess(im) for im in images[i::2]]) for i in (0, 1)]
    torch.cuda.synchronize()
    prep_ms = (time.perf_counter() - t0) / (2 * n) * 1e3
    if kernels.launch_counts() != NONE:
        raise SystemExit(f"FFA's matting launched {kernels.launch_counts()}")
    print(f"  U^2-Netp matting and preprocessing: {prep_ms:.1f} ms an image (host work in); "
          f"foreground share of the mattes {float((rgba[0][..., 3] > 0).mean()):.3f}",
          flush=True)
    run("cute", "cute (FFA, Crop-Feat)", lambda: ffa.score_batch("Crop-Feat", *rgba), _cos)
    out["cute"]["matting_ms_per_image"] = prep_ms
    masks_ms = []
    for _ in range(5):  # the call's host masks alone, as _features_dispatch computes them
        t0 = time.perf_counter()
        for r in rgba:
            ffa._masks(r[..., :3])
        masks_ms.append((time.perf_counter() - t0) * 1e3)
    masks_ms = float(np.median(masks_ms))
    print(f"  cute (FFA): the host's foreground masks of one call ({2 * n} images) alone "
          f"{masks_ms:.2f} ms (median of 5), {100 * masks_ms / out['cute']['call_ms']:.1f} % of "
          "the call", flush=True)
    out["cute"]["masks_ms"] = masks_ms
    slowest = max(out, key=lambda k: out[k]["call_ms"])
    profile_call(fns[slowest], f"{slowest} call ({n} pairs), the slowest baseline call")
    del fns, clip, dino, dinov1, lpips, gram, ffa
    torch.cuda.empty_cache()
    return out


BASELINE_CLI = ("clip_i", "clip_cross", "clipfeats", "dino", "dinov1", "dino_cross", "dinofeats",
                "lpips", "gram")


def baseline_cli_phase(tree: str, u2net_npz: str) -> dict:
    """The CLI with every baseline metric over the 36 JPEGs (60 comparisons, 4 pair calls), no
    K1-K4 launch; ``cute --matting_weights`` and ``diffsim --use_mask --matting_weights`` with
    the converter's U^2-Netp; and ``--metric ensemble`` with its predicted launches."""
    phase("the 2AFC CLI with the baseline metrics: cute --preset cute --metric "
          f"{'|'.join(BASELINE_CLI)}|cute --matting_weights, diffsim --use_mask "
          "--matting_weights, and --metric ensemble (diffsim, clip_i, dino)")
    plan = benchmarks.cute(tree, 2334)
    calls = -(-len(plan) // CLI_BATCH)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs = {m: (["--metric", m], NONE) for m in BASELINE_CLI}
        runs["cute"] = (["--metric", "cute", "--matting_weights", u2net_npz], NONE)
        runs["diffsim_u2net_masks"] = (["--use_mask", "--matting_weights", u2net_npz],
                                       {k: v * calls for k, v in SD15_CALL.items()})
        for what, (extra, want) in runs.items():
            report, adapter, scores, counts, _, wall = _cli_run(
                what, tree, os.path.join(tmp, f"{what}.jsonl"), *extra)
            if report.total != len(plan) or sorted(scores) != list(range(len(plan))):
                raise SystemExit(f"{what}: scored {report.total} of {len(plan)} comparisons")
            if counts != want:
                raise SystemExit(f"{what}: launched {counts}, expected {want}")
            if not np.isfinite(np.array(list(scores.values()))).all():
                raise SystemExit(f"{what}: scores not finite")
            out[what] = {"pairs_per_s": 2 * len(plan) / wall, "accuracy": report.accuracy,
                         "counts": counts}
            del adapter
            torch.cuda.empty_cache()
        out["ensemble"] = _ensemble_run(tree, os.path.join(tmp, "ensemble.jsonl"), plan)
    return out


def _ensemble_run(tree: str, path: str, plan) -> dict:
    """``--metric ensemble`` over the 36 JPEGs: its diffsim member takes the moment cache's path
    (one UNet forward a scoring call: 8 K1 and 4 K2, as the cached CLI run), CLIP-I and DINOv2
    the math path; the report follows the members' 2-of-3 vote."""
    argv = ["--preset", "cute", "--image_path", tree, "--batch_size", str(CLI_BATCH),
            "--metric", "ensemble", "--results", path]
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report, adapters = run_benchmark("cute", argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    step = resolve_cached_chunk(CLI_BATCH, None, adapters[0].scorer)
    forwards = sum(-(-len(plan[i:i + CLI_BATCH]) // step) for i in range(0, len(plan), CLI_BATCH))
    want = {**NONE, "fused_self_attention": 8 * forwards, "fused_geglu_ff": 4 * forwards}
    logs = []
    for m in range(3):
        with open(f"{path}.m{m}") as f:
            logs.append({r["idx"]: (r["s_ab"], r["s_ac"]) for r in map(json.loads, f)})
    votes = sum(np.array([[s[i][0] > s[i][1] for i in range(len(plan))] for s in logs]))
    print(f"  ensemble: {report.total} comparisons in {wall:.2f} s with the three scorers' "
          f"init, {2 * report.total / wall:.2f} pairs/s (information only); launches {counts}, "
          f"predicted {want} ({forwards} UNet forwards); accuracy {report.accuracy:.2f} %",
          flush=True)
    if report.total != len(plan) or any(sorted(s) != list(range(len(plan))) for s in logs):
        raise SystemExit("ensemble: a member's log misses comparisons")
    if report.correct != int((votes >= 2).sum()):
        raise SystemExit("ensemble: the report does not follow the 2-of-3 vote")
    if counts != want:
        raise SystemExit(f"ensemble: launched {counts}, predicted {want}")
    del adapters
    torch.cuda.empty_cache()
    return {"pairs_per_s": 2 * report.total / wall, "counts": counts,
            "accuracy": report.accuracy}


def _vit_shapes(prefix: str, layers: int, h: int, inter: int, names) -> dict:
    """The shapes of ``layers`` ViT layers under ``prefix``.<i> with the (norm1, q, k, v, out,
    norm2, fc1, fc2) ``names`` of a published checkpoint."""
    n1, q, k, v, o, n2, f1, f2 = names
    shapes = {}
    for i in range(layers):
        base = f"{prefix}.{i}"
        for nm in (n1, n2):
            shapes[f"{base}.{nm}.weight"] = shapes[f"{base}.{nm}.bias"] = (h,)
        for nm in (q, k, v, o):
            shapes[f"{base}.{nm}.weight"], shapes[f"{base}.{nm}.bias"] = (h, h), (h,)
        shapes[f"{base}.{f1}.weight"], shapes[f"{base}.{f1}.bias"] = (inter, h), (inter,)
        shapes[f"{base}.{f2}.weight"], shapes[f"{base}.{f2}.bias"] = (h, inter), (h,)
    return shapes


CLIP_LAYER = ("layer_norm1", "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
              "self_attn.out_proj", "layer_norm2", "mlp.fc1", "mlp.fc2")


def published_clip_sd(gen) -> dict:
    """HF ``CLIPModel`` (openai/clip-vit-base-patch32) names and shapes: both towers."""
    vc, h = CLIPVisionConfig.b32(), 768
    shapes = {"vision_model.embeddings.class_embedding": (h,),
              "vision_model.embeddings.patch_embedding.weight": (h, 3, vc.patch, vc.patch),
              "vision_model.embeddings.position_embedding.weight": (vc.tokens, h),
              "vision_model.pre_layrnorm.weight": (h,), "vision_model.pre_layrnorm.bias": (h,),
              "vision_model.post_layernorm.weight": (h,),
              "vision_model.post_layernorm.bias": (h,),
              "visual_projection.weight": (512, h),
              "text_model.embeddings.token_embedding.weight": (49408, 512),
              "text_model.embeddings.position_embedding.weight": (77, 512),
              "text_model.final_layer_norm.weight": (512,),
              "text_model.final_layer_norm.bias": (512,),
              "text_projection.weight": (512, 512)}
    shapes.update(_vit_shapes("vision_model.encoder.layers", 12, h, 3072, CLIP_LAYER))
    shapes.update(_vit_shapes("text_model.encoder.layers", 12, 512, 2048, CLIP_LAYER))
    return _draw(shapes, gen)


def published_dinov2_sd(cfg, gen) -> dict:
    """HF ``Dinov2Model`` names and shapes (facebook/dinov2-base at ``DinoConfig.v2_base``)."""
    h, p = cfg.hidden, cfg.patch
    shapes = {"embeddings.cls_token": (1, 1, h), "embeddings.mask_token": (1, h),
              "embeddings.position_embeddings": (1, cfg.pos_grid ** 2 + 1, h),
              "embeddings.patch_embeddings.projection.weight": (h, 3, p, p),
              "embeddings.patch_embeddings.projection.bias": (h,),
              "layernorm.weight": (h,), "layernorm.bias": (h,)}
    shapes.update(_vit_shapes("encoder.layer", cfg.layers, h, cfg.intermediate, (
        "norm1", "attention.attention.query", "attention.attention.key",
        "attention.attention.value", "attention.output.dense", "norm2", "mlp.fc1", "mlp.fc2")))
    for i in range(cfg.layers):
        for j in (1, 2):
            shapes[f"encoder.layer.{i}.layer_scale{j}.lambda1"] = (h,)
    return _draw(shapes, gen)


def published_dino_v1_sd(cfg, gen) -> dict:
    """facebookresearch/dino ``dino_vits8`` names and shapes: fused qkv."""
    h, p = cfg.hidden, cfg.patch
    shapes = {"cls_token": (1, 1, h), "pos_embed": (1, cfg.pos_grid ** 2 + 1, h),
              "patch_embed.proj.weight": (h, 3, p, p), "patch_embed.proj.bias": (h,),
              "norm.weight": (h,), "norm.bias": (h,)}
    for i in range(cfg.layers):
        b = f"blocks.{i}"
        shapes.update({f"{b}.norm1.weight": (h,), f"{b}.norm1.bias": (h,),
                       f"{b}.attn.qkv.weight": (3 * h, h), f"{b}.attn.qkv.bias": (3 * h,),
                       f"{b}.attn.proj.weight": (h, h), f"{b}.attn.proj.bias": (h,),
                       f"{b}.norm2.weight": (h,), f"{b}.norm2.bias": (h,),
                       f"{b}.mlp.fc1.weight": (cfg.intermediate, h),
                       f"{b}.mlp.fc1.bias": (cfg.intermediate,),
                       f"{b}.mlp.fc2.weight": (h, cfg.intermediate), f"{b}.mlp.fc2.bias": (h,)})
    return _draw(shapes, gen)


def published_vgg_sd(cfg, gen, prefix: str = "features.") -> dict:
    """torchvision ``vgg*.features`` names and shapes, convolutions at He's scale."""
    out, idx, cin = {}, 0, 3
    for item in cfg:
        if item == "M":
            idx += 1
            continue
        out[f"{prefix}{idx}.weight"] = (torch.randn((item, cin, 3, 3), generator=gen)
                                        * (2.0 / (9 * cin)) ** 0.5).to(torch.bfloat16)
        out[f"{prefix}{idx}.bias"] = torch.zeros(item, dtype=torch.bfloat16)
        cin, idx = item, idx + 2
    return out


def published_u2net_sd(cfg, gen) -> dict:
    """The published u2net repository's names and shapes (REBNCONV ``conv_s1`` / ``bn_s1`` with
    torch's BatchNorm buffers), float32, convolutions at He's scale."""
    sd = {}

    def conv(name, cin, cout, k=3):
        sd[f"{name}.weight"] = torch.randn((cout, cin, k, k), generator=gen) * (
            2.0 / (k * k * cin)) ** 0.5
        sd[f"{name}.bias"] = torch.zeros(cout)

    def rebnconv(name, cin, cout):
        conv(f"{name}.conv_s1", cin, cout)
        sd[f"{name}.bn_s1.weight"] = 1.0 + 0.05 * torch.randn(cout, generator=gen)
        sd[f"{name}.bn_s1.bias"] = 0.05 * torch.randn(cout, generator=gen)
        sd[f"{name}.bn_s1.running_mean"] = 0.05 * torch.randn(cout, generator=gen)
        sd[f"{name}.bn_s1.running_var"] = 1.0 + 0.05 * torch.rand(cout, generator=gen)
        sd[f"{name}.bn_s1.num_batches_tracked"] = torch.tensor(0)

    def rsu(name, height, cin, mid, cout):
        rebnconv(f"{name}.rebnconvin", cin, cout)
        rebnconv(f"{name}.rebnconv1", cout, mid)
        depth = 4 if height == 0 else height
        for i in range(2, depth + 1):
            rebnconv(f"{name}.rebnconv{i}", mid, mid)
        for i in range(depth - 1, 1, -1):
            rebnconv(f"{name}.rebnconv{i}d", 2 * mid, mid)
        rebnconv(f"{name}.rebnconv1d", 2 * mid, cout)

    for i, stage in enumerate(cfg.encoder, start=1):
        rsu(f"stage{i}", *stage)
    for i, stage in zip(range(5, 0, -1), cfg.decoder):
        rsu(f"stage{i}d", *stage)
    for i, cin in enumerate(cfg.side_channels, start=1):
        conv(f"side{i}", cin, 1)
    conv("outconv", 6, 1, k=1)
    return sd


def convert_baselines_phase(tmp: str) -> dict:
    """The six baseline families of the convert CLI on this machine, in a process where
    importing jax, safetensors or ml_dtypes raises, on checkpoints of published names and
    shapes at full width (bf16 safetensors written here; U^2-Netp as a ``torch.save`` state
    dict); each ``.npz`` through the ``--weights`` reader into its scorer on the card, equal to
    the checkpoint's weights, scoring. Returns {family: .npz path}."""
    phase("the convert CLI's baseline families on this machine (clip, dinov2 --size base, "
          "dinov1, vgg19, lpips --vgg, u2net), with jax, safetensors and ml_dtypes made to raise "
          "on import; each .npz through the --weights reader into its scorer on the card")
    gen = torch.Generator().manual_seed(2340)
    root = os.path.dirname(os.path.abspath(__file__))
    sds = {"clip": published_clip_sd(gen),
           "dinov2": published_dinov2_sd(DinoConfig.v2_base(), gen),
           "dinov1": published_dino_v1_sd(DinoConfig.v1_vits8(), gen),
           "vgg19": published_vgg_sd(VGG19_CFG, gen),
           "lpips": {f"lin{i}.model.1.weight": torch.rand((1, c, 1, 1), generator=gen).to(
               torch.bfloat16) for i, c in enumerate((64, 128, 256, 512, 512))},
           "lpips_vgg": published_vgg_sd(VGG16_CFG, gen),
           "u2net": published_u2net_sd(U2NetConfig.u2netp(), gen)}
    files = {}
    for name, sd in sds.items():
        if name == "u2net":
            files[name] = os.path.join(tmp, "u2netp.pth")
            torch.save(sd, files[name])
        else:
            files[name] = os.path.join(tmp, f"{name}.safetensors")
            write_safetensors(files[name], sd)
    argvs = {"clip": ["--model", files["clip"]],
             "dinov2": ["--model", files["dinov2"], "--size", "base"],
             "dinov1": ["--model", files["dinov1"]],
             "vgg19": ["--model", files["vgg19"]],
             "lpips": ["--model", files["lpips"], "--vgg", files["lpips_vgg"]],
             "u2net": ["--model", files["u2net"]]}
    npz = {}
    for family, extra in argvs.items():
        npz[family] = os.path.join(tmp, f"{family}.npz")
        cmd = [sys.executable, "-c", CONVERT_CLI, family, *extra, "--out", npz[family]]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600)
        print(f"  convert {family}: rc {res.returncode} in {time.perf_counter() - t0:.1f} s: "
              f"{res.stdout.strip()}", flush=True)
        if res.returncode:
            print(res.stderr[-4000:], flush=True)
            raise SystemExit(f"the convert CLI failed on {family}")
    load = registry._load_params  # the --weights reader

    def same(ours, ref) -> bool:
        return torch.equal(ours.detach().cpu(), ref.float())

    clip = CLIPScore(load(npz["clip"]))
    dinov2 = Dinov2Score(load(npz["dinov2"]), cfg=DinoConfig.v2_base())
    dinov1 = DinoScore(load(npz["dinov1"]))
    gram = VGGGram(load(npz["vgg19"]))
    lpips = LPIPS(load(npz["lpips"]))
    u2net = U2NetMatting(load(npz["u2net"]))
    checks = {
        "clip": same(clip.model.vision.layers[3].attn.q.weight,
                     sds["clip"]["vision_model.encoder.layers.3.self_attn.q_proj.weight"])
        and same(clip.model.text.text_projection.weight, sds["clip"]["text_projection.weight"]),
        "dinov2": same(dinov2.model.layers[5].ls2, sds["dinov2"][
            "encoder.layer.5.layer_scale2.lambda1"]),
        "dinov1": same(dinov1.model.layers[2].attn.k.weight,
                       sds["dinov1"]["blocks.2.attn.qkv.weight"][384:768]),
        "vgg19": same(gram.model.convs[8].weight, sds["vgg19"]["features.19.weight"]),
        "lpips": same(lpips.model.lins[4].w, sds["lpips"]["lin4.model.1.weight"].reshape(-1))
        and same(lpips.model.vgg.convs[0].weight, sds["lpips_vgg"]["features.0.weight"]),
        "u2net": same(u2net.model.stage4d.rebnconv2d.bn.var,
                      sds["u2net"]["stage4d.rebnconv2d.bn_s1.running_var"].to(torch.bfloat16)),
    }
    if not all(checks.values()):
        raise SystemExit(f"the converted weights on the card differ from the checkpoints': "
                         f"{checks}")
    rng = np.random.default_rng(7)
    p224 = [rng.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8) for _ in range(2)]
    p64 = [rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8) for _ in range(2)]
    scores = {"clip_i": clip.clipi_score_batch(*p224), "dinov1": dinov1.dino_score_batch(*p224),
              "dino_base": dinov2.dino_score_batch(*p224), "gram": gram.score_batch(*p64),
              "lpips": lpips.score_batch(*p64),
              "u2net_saliency_mean": np.array([u2net.saliency(_salient_image(rng)).mean()])}
    if not all(np.isfinite(s).all() for s in scores.values()):
        raise SystemExit(f"the converted baselines scored non-finite values: {scores}")
    print(f"  the converted weights on the card equal the checkpoints' ({sorted(checks)}); "
          f"scores {({k: np.round(v, 4).tolist() for k, v in scores.items()})}", flush=True)
    del clip, dinov2, dinov1, gram, lpips, u2net
    torch.cuda.empty_cache()
    return npz


def sd15_fast_768_phase() -> dict:
    phase("SD-1.5 pair path in fast mode at 768 px: the VAE mid attention (9216 tokens, D 512, "
          "bf16) runs K4 in the bf16_probs mode")
    scorer = DiffSimSD15(img_size=768, fast_softmax=True)
    rng = np.random.default_rng(4)
    pix = [rng.integers(0, 256, (1, 768, 768, 3), dtype=np.uint8) for _ in range(2)]
    kernels.reset_launch_counts()
    scores = scorer.score_batch(*pix, **CUTE)
    torch.cuda.synchronize()
    counts, fast = kernels.launch_counts(), kernels.bf16_probs_launch_counts()
    print(f"  score_batch (1 pair, 768 px): {scores}; launches {counts}, in the bf16_probs mode "
          f"{fast}", flush=True)
    _check_scores("the 768 px fast pair", scores)
    if (counts["streaming_self_attention"] != 1 or fast != {
            "fused_self_attention": counts["fused_self_attention"],
            "streaming_self_attention": 1} or counts["fused_self_attention"] == 0):
        raise SystemExit("the 768 px fast pair path did not run K1 and K4 in the mode")
    del scorer
    torch.cuda.empty_cache()
    return {"counts": counts, "fast_counts": fast}


def cached_path(name, scorer, pix, s_ab, s_ac, args, miss_calls, hit_calls,
                none_in_mode: bool = False, all_float32: bool = False) -> float:
    """``score_triplet_paths`` on a main-path phase's triplets written to disk as PNGs, with
    exact launch counts: within 1e-2 of ``score_triplet_batch`` (the miss slab and the fresh
    batch may encode different numbers of images at once, and cuDNN picks its algorithms per
    shape), and an all-hit rescore bit for bit. Returns the cached-vs-fresh gap."""
    from PIL import Image

    t = len(pix[0])
    with tempfile.TemporaryDirectory() as tmp:
        roles = []
        for r, arr in zip("abc", pix):
            roles.append([os.path.join(tmp, f"{r}{i}.png") for i in range(len(arr))])
            for path, img in zip(roles[-1], arr):
                Image.fromarray(img).save(path)
        (c_ab, c_ac), _ = _checked_call(f"score_triplet_paths ({t} triplets, all misses)",
                                        lambda: scorer.score_triplet_paths(*roles, **args),
                                        miss_calls, none_in_mode, all_float32)
        (h_ab, h_ac), _ = _checked_call(f"score_triplet_paths ({t} triplets, all hits)",
                                        lambda: scorer.score_triplet_paths(*roles, **args),
                                        hit_calls, none_in_mode, all_float32)
    gap = max(np.abs(c_ab - s_ab).max(), np.abs(c_ac - s_ac).max())
    print(f"  cached {c_ab} {c_ac} vs fresh: max |d| = {gap:.3e} (limit 1e-2); cache "
          f"{scorer._moment_cache.stats}", flush=True)
    if gap > 1e-2 or not (np.array_equal(h_ab, c_ab) and np.array_equal(h_ac, c_ac)):
        raise SystemExit(f"{name} score_triplet_paths disagrees with the fresh path or itself")
    return float(gap)


# ---------------------------------------------------------------------------
# DiT training and sampling (K1 under autograd)
# ---------------------------------------------------------------------------

# DiT-XL/2 at 256 px, the published per-GPU batch of 32: every block's attention is
# (32, 16, 256, 72), 28 per forward and 28 backward launches (csrc/fused_attention_bwd.cu) a
# step; under --remat the backward runs each block's forward again
TRAIN_BATCH, TRAIN_SIZE = 32, 256
DIT_TRAIN_SITE = (TRAIN_BATCH, 16, 256, 72)
TRAIN_STEP = {**NONE, "fused_self_attention": 28, "fused_self_attention_bwd": 28}
REMAT_STEP = {**NONE, "fused_self_attention": 56, "fused_self_attention_bwd": 28}
SAMPLE_STEPS = 50
# the sampler's CFG batch: the 8 default labels and their null-class copies, in float32
DIT_SAMPLE_SITE = (2 * 8, 16, 256, 72)
# K1's forward and gradient are checked at the training site and at two small shapes
K1_GRAD_SHAPES = [DIT_TRAIN_SITE, (2, 3, 256, 72), (2, 3, 1024, 80)]
# the tiny training step, card vs CPU: DiT-XL/2's head dim 72 at 256 tokens, so K1 routes
TINY_TRAIN = dict(input_size=32, patch_size=2, hidden=144, depth=2, heads=2, num_classes=10,
                  learn_sigma=True)
# K1 in the tiny VAE's mid attention (1024 tokens at D 64, no grad) and in both DiT blocks, and
# its backward in both blocks
TINY_TRAIN_STEP = {**NONE, "fused_self_attention": 3, "fused_self_attention_bwd": 2}
# the backward's shapes that the training site does not reach, each against the plain version: a
# head off the granule (D 36, zero-padded to 40), the widest head, the 512 px DiT's 1024 tokens,
# and B*H past the grid's 65535 (two launches)
K1_BWD_SHAPES = [(2, 3, 256, 36), (2, 3, 256, 160), (1, 4, 1024, 72), (65536, 1, 64, 8)]
K1_GRAD_TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-2, 1e-2)}


def _bwd_check(name, q, k, v, g, tol) -> float:
    """The backward kernel's (dq, dk, dv) against ``fused_self_attention_bwd_plain`` on the same
    inputs, with the launches its plan takes; a second call must give them bit for bit."""
    plan = kattn.bwd_launch_plan(q.shape, q.dtype)
    got, took = _counted(fused_self_attention_bwd, lambda: fused_self_attention_bwd(q, k, v, g))
    torch.cuda.synchronize()
    if took != len(plan.slices) or any(t.shape != q.shape or t.dtype != q.dtype
                                       or not t.is_contiguous() for t in got):
        raise SystemExit(f"{name} backward: {took} launch(es) for {len(plan.slices)} slice(s), "
                         f"gradients {[(tuple(t.shape), t.dtype) for t in got]}")
    with torch.no_grad():
        ref = kattn.fused_self_attention_bwd_plain(q, k, v, g)
    err = max(check_close(f"{name} backward kernel d{x}", a, b, *tol)
              for x, a, b in zip("qkv", got, ref))
    del ref
    again = fused_self_attention_bwd(q, k, v, g)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise SystemExit(f"{name} backward: a second call gave other gradients")
    return err


def k1_grad_phase(gen) -> dict:
    phase("K1 under autograd (DiT training): the FusedSelfAttention Function's output (the "
          "kernel's forward) vs fused_self_attention_plain, torch.autograd.grad through the "
          "Function (the backward kernels, csrc/fused_attention_bwd.cu) vs through the plain "
          "version, and the backward kernels vs fused_self_attention_bwd_plain (the port of "
          f"_fused_bwd), bit for bit on a second call, at {K1_GRAD_SHAPES}, and the backward "
          f"alone at {K1_BWD_SHAPES}, on the card (float32 atol 1e-5, bf16 atol=rtol=1e-2); the "
          "backward timed at the training site in turns with its first design "
          "(csrc/fused_attention_bwd_v1.cu), each split by kernel; then the sampler's no-grad "
          "forward at its CFG batch")
    for source in ("fused_attention_bwd", "fused_attention_bwd_v1"):
        usage = ptxas_usage(source, "bwd_")
        print(f"  {source}.cu, ptxas (the training site's instantiations, 80 columns, and the "
              "float32 statistics pass's 72):" if usage else
              f"  {source}.cu: built before this run, no ptxas report", flush=True)
        for line in usage:
            if "Li80E" in line or "Li72E" in line:
                print(f"    {line}", flush=True)
    rows, bwd_rows, err_of, grad_err_of, bwd_err_of = [], [], {}, {}, {}
    for shape in K1_GRAD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                          for _ in range(4))
            qkv = [t.clone().requires_grad_() for t in (q, k, v)]
            out = fused_self_attention(*qkv)
            if type(out.grad_fn).__name__ != "FusedSelfAttentionBackward":
                raise SystemExit(f"K1 under grad: grad_fn {type(out.grad_fn).__name__}, not the "
                                 "FusedSelfAttention Function")
            grads, took = _counted(fused_self_attention_bwd,
                                   lambda: torch.autograd.grad(out, qkv, g))
            torch.cuda.synchronize()
            if took != 1:
                raise SystemExit(f"K1 under grad at {shape}: the backward launched {took} "
                                 "kernel(s), not 1")
            tol = K1_GRAD_TOL[dtype]
            name = f"K1 {shape} {str(dtype)[6:]}"
            with torch.no_grad():
                err = check_close(f"{name} forward", out, fused_self_attention_plain(q, k, v),
                                  *tol)
            ref_qkv = [t.clone().requires_grad_() for t in (q, k, v)]
            ref = torch.autograd.grad(fused_self_attention_plain(*ref_qkv), ref_qkv, g)
            grad_err = max(check_close(f"{name} grad d{x}", a, b, *tol)
                           for x, a, b in zip("qkv", grads, ref))
            del out, grads, ref, qkv, ref_qkv
            bwd_err = _bwd_check(name, q, k, v, g, tol)
            row = {"shape": list(shape), "dtype": str(dtype)[6:], "max_abs_err": err,
                   "grad_max_abs_err": grad_err}
            err_of[dtype] = max(err_of.get(dtype, 0.0), err)
            grad_err_of[dtype] = max(grad_err_of.get(dtype, 0.0), grad_err, bwd_err)
            bwd_err_of[dtype] = max(bwd_err_of.get(dtype, 0.0), bwd_err)
            if shape == DIT_TRAIN_SITE:
                b, h, s, d = shape
                key = ("launches_dit_train_step" if dtype == torch.float32
                       else "launches_dit_train_step_bf16")
                row[key] = TRAIN_STEP["fused_self_attention"]
                with torch.no_grad():
                    _timed(row, lambda: fused_self_attention(q, k, v),
                           lambda: fused_self_attention_plain(q, k, v),
                           4 * b * h * s * s * d, 4 * b * h * s * d * q.element_size(),
                           library=lambda: F.scaled_dot_product_attention(q, k, v),
                           v2=v2_f32_attention(q, k, v, tol) if dtype == torch.float32
                           else None,
                           dtype=dtype, exps=b * h * s * s,
                           tf32_passes=3.0 if dtype == torch.float32 else 0.0)
                # the backward kernel beside its plain version (five (S, S) products in
                # torch.matmul, the weights recomputed), SDPA's backward on the same inputs and
                # the bound of the five products
                print("    backward:", flush=True)
                bwd_row = {"shape": list(shape), "dtype": str(dtype)[6:],
                           "max_abs_err": bwd_err, key: TRAIN_STEP["fused_self_attention_bwd"]}
                qs = [t.clone().requires_grad_() for t in (q, k, v)]
                sdpa_out = F.scaled_dot_product_attention(*qs)
                v1 = v1_bwd(q, k, v, g, tol)
                _timed(bwd_row, lambda: fused_self_attention_bwd(q, k, v, g),
                       lambda: kattn.fused_self_attention_bwd_plain(q, k, v, g),
                       10 * b * h * s * s * d, 7 * b * h * s * d * q.element_size(),
                       library=lambda: torch.autograd.grad(sdpa_out, qs, g, retain_graph=True),
                       v2=v1, dtype=dtype, exps=b * h * s * s,
                       tf32_passes=3.0 if dtype == torch.float32 else 0.0)
                # the split by kernel: the statistics pass and the key kernel, the first
                # design's two kernels
                for what, fn in (("shipped", lambda: fused_self_attention_bwd(q, k, v, g)),
                                 ("first design", v1)):
                    split = device_ms(fn)[1]
                    bwd_row["split_v1" if fn is v1 else "split"] = split
                    print(f"    {what}, by kernel: " + ("; ".join(
                        f"{t:.4f} {name[:70]}" for name, t in sorted(split.items(),
                                                                     key=lambda kv: -kv[1]))
                        or "no per-kernel split (CUDA events)"), flush=True)
                steps = TRAIN_STEP["fused_self_attention_bwd"]
                print(f"    backward a training step ({steps} launches): kernel "
                      f"{bwd_row['ms'] * steps:.3f} ms, first design "
                      f"{bwd_row['v2_ms'] * steps:.3f}, plain {bwd_row['plain_ms'] * steps:.3f}, "
                      f"SDPA's backward {bwd_row['library_ms'] * steps:.3f}, bound "
                      f"{bwd_row['bound_ms'] * steps:.3f} ({bwd_row['bound_by']})", flush=True)
                bwd_rows.append(bwd_row)
                del qs, sdpa_out, v1
            rows.append(row)
            del q, k, v, g
            torch.cuda.empty_cache()
    for shape in K1_BWD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                          for _ in range(4))
            err = _bwd_check(f"K1 {shape} {str(dtype)[6:]}", q, k, v, g, K1_GRAD_TOL[dtype])
            bwd_rows.append({"shape": list(shape), "dtype": str(dtype)[6:], "max_abs_err": err,
                             "launches": len(kattn.bwd_launch_plan(shape, dtype).slices)})
            bwd_err_of[dtype] = max(bwd_err_of[dtype], err)
            del q, k, v, g
            torch.cuda.empty_cache()
    b, h, s, d = DIT_SAMPLE_SITE
    q, k, v = (torch.randn(DIT_SAMPLE_SITE, generator=gen, device="cuda") for _ in range(3))
    with torch.no_grad():
        err = check_close(f"K1 {DIT_SAMPLE_SITE} float32 (sampler, no grad)",
                          fused_self_attention(q, k, v), fused_self_attention_plain(q, k, v),
                          1e-5, 0.0)
        row = {"shape": list(DIT_SAMPLE_SITE), "dtype": "float32", "max_abs_err": err,
               "launches_dit_sample_step": TRAIN_STEP["fused_self_attention"]}
        _timed(row, lambda: fused_self_attention(q, k, v),
               lambda: fused_self_attention_plain(q, k, v),
               4 * b * h * s * s * d, 4 * b * h * s * d * q.element_size(),
               library=lambda: F.scaled_dot_product_attention(q, k, v),
               v2=v2_f32_attention(q, k, v, (1e-5, 0.0)), dtype=torch.float32,
               exps=b * h * s * s,
               tf32_passes=3.0)
    rows.append(row)
    err_of[torch.float32] = max(err_of[torch.float32], err)
    del q, k, v
    torch.cuda.empty_cache()
    return {"rows": rows, "err": err_of, "grad_err": grad_err_of, "bwd_rows": bwd_rows,
            "bwd_err": bwd_err_of}


# K1-K3 at the shapes their kernels take only through the wrapper's launch plan: heads off the
# granule of 8 (K1, K3) and C off K2's 32, zero-padded (the scale at the true D), and more rows
# than a grid's y axis takes, one launch a slice
DOMAIN_K1_DIMS = (20, 36, 100, 156)
DOMAIN_K1_SEQS = (64, 256)
DOMAIN_K1_SPLIT = (65536, 1, 64, 40)  # B*H = 65536: 65535 rows, then 1
DOMAIN_K3_DIMS = (20, 100)
DOMAIN_K3_SPLIT = (2, 2, 16384, 64, 72)  # N = P*B*H = 65536 rows at S = 64: two launches
DOMAIN_K2_DIMS = (40, 200)
DOMAIN_K2_ROWS = 4096
DOMAIN_K2_SPLIT = (65535 * 64 + 64, 32)  # one 64-row tile past the grid: two launches
DOMAIN_K1_GRAD = (2, 4, 256, 36)
# the existing phases' limits against the plain versions: K1 exact (atol, rtol), K1's bf16_probs
# mode, K2, K3's scores (atol and rtol of the distance)
DOMAIN_K1_TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-2, 1e-2)}
DOMAIN_K1_FAST_TOL = (1e-2, 1e-2)
DOMAIN_K2_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
DOMAIN_K3_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
# K3's per-row partials at a launch boundary have no earlier limit: relative, float32 at K3's
# 1e-5, bf16 at K1's and K2's elementwise 1e-2; a row read or written at a wrong offset is O(1)
# away
DOMAIN_PARTIAL_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _counted(wrapper, fn):
    """``fn()`` and the launches it added to ``wrapper.launches``."""
    before = wrapper.launches
    out = fn()
    torch.cuda.synchronize()
    return out, wrapper.launches - before


def _domain_check(name, out, ref, shape, took, launches, tol) -> float:
    """A padded or split call against its plain version: its shape, contiguity and number of
    launches, then the error (printed only if it fails)."""
    if tuple(out.shape) != tuple(shape) or not out.is_contiguous():
        raise SystemExit(f"{name}: the call gave {tuple(out.shape)} "
                         f"(contiguous {out.is_contiguous()}), not {tuple(shape)}")
    if took != launches:
        raise SystemExit(f"{name}: {took} launch(es), expected {launches}")
    return check_close(name, out, ref, *tol, quiet=True)


def _boundary(name, out, ref, rows, tol) -> float:
    """Rows of dim 0 on both sides of a launch boundary, against the plain version."""
    idx = torch.tensor(rows, device=out.device)
    return check_close(f"{name} rows {list(rows)}", out.index_select(0, idx),
                       ref.index_select(0, idx), *tol)


def _domain_taps(shape, dtype, gen):
    """(qa, ka, va, kb, vb): image B's keys and values are image A's plus noise (cosine ~0.9)."""
    qa, ka, va = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
    kb, vb = (x + 0.3 * torch.randn(shape, generator=gen, device="cuda") for x in (ka, va))
    return [x.to(dtype) for x in (qa, ka, va, kb, vb)]


def _domain_k1(gen, out: dict) -> None:
    split = DOMAIN_K1_SPLIT
    for dtype in (torch.float32, torch.bfloat16):
        name = _dtype_name(dtype)
        for bf16_probs in (False, True):
            tol = DOMAIN_K1_FAST_TOL if bf16_probs else DOMAIN_K1_TOL[dtype]
            mode = " bf16_probs" if bf16_probs else ""
            errs = []
            for d in DOMAIN_K1_DIMS:
                for s in DOMAIN_K1_SEQS:
                    shape = (2, 3, s, d)
                    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                               for _ in range(3))
                    got, took = _counted(fused_self_attention,
                                         lambda: fused_self_attention(q, k, v, bf16_probs))
                    errs.append(_domain_check(f"K1 {shape} {name}{mode} (padded to {d + -d % 8})",
                                              got, fused_self_attention_plain(q, k, v, bf16_probs),
                                              shape, took, 1, tol))
            out[f"k1 {name}{mode} padded"] = max(errs)
            print(f"  K1 {name}{mode} at D {DOMAIN_K1_DIMS} (zero-padded to 8), S "
                  f"{DOMAIN_K1_SEQS}: max|kernel - plain| = {max(errs):.3e} (atol {tol[0]}, rtol "
                  f"{tol[1]}), 1 launch each, shapes and contiguity ok", flush=True)
            q, k, v = (torch.randn(split, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            plan = kattn.launch_plan(split, dtype)
            got, took = _counted(fused_self_attention,
                                 lambda: fused_self_attention(q, k, v, bf16_probs))
            ref = fused_self_attention_plain(q, k, v, bf16_probs)
            what = f"K1 {split} {name}{mode} (B*H > 65535, {took} launches)"
            if len(plan.slices) != 2:
                raise SystemExit(f"{what}: the plan has {len(plan.slices)} slices, not 2")
            err = _domain_check(what, got, ref, split, took, 2, tol)
            cut = plan.slices[1][0]
            edge = _boundary(what, got, ref, (cut - 2, cut - 1, cut), tol)
            out[f"k1 {name}{mode} B*H 65536"] = {"max_abs_err": err, "boundary_err": edge,
                                                 "launches": took}
            print(f"  {what}: max|kernel - plain| = {err:.3e} over the output", flush=True)
            del q, k, v, got, ref
            torch.cuda.empty_cache()


def _domain_k3(gen, out: dict) -> None:
    for dtype in (torch.float32, torch.bfloat16):
        name, tol = _dtype_name(dtype), DOMAIN_K3_TOL[dtype]
        for d in DOMAIN_K3_DIMS:
            shape = (2, 2, 2, 512, d)
            taps = _domain_taps(shape, dtype, gen)
            for similarity in ("cosine", "mse"):
                got, took = _counted(cross_self_partials,
                                     lambda: fused_direction_score(*taps, similarity))
                if tuple(got.shape) != (2,) or took != 1:
                    raise SystemExit(f"K3 {shape} {name}: scores {tuple(got.shape)}, {took} "
                                     "launch(es), expected (2,) and 1")
                out[f"k3 {name} D {d} {similarity}"] = check_score(
                    f"K3 {shape} {name} {similarity} (padded to {d + -d % 8})", got,
                    fused_direction_score_plain(*taps, similarity), similarity, tol, tol)
        taps = _domain_taps(DOMAIN_K3_SPLIT, dtype, gen)
        p, b, h, s, d = DOMAIN_K3_SPLIT
        plan = readout.launch_plan((p * b * h, s, d), dtype)
        for similarity in ("cosine", "mse"):
            got, took = _counted(cross_self_partials,
                                 lambda: fused_direction_score(*taps, similarity))
            what = f"K3 {DOMAIN_K3_SPLIT} {name} {similarity} (N > 65535, {took} launches)"
            if took != len(plan.slices) or len(plan.slices) != 2:
                raise SystemExit(f"{what}: expected 2 launches")
            out[f"k3 {name} N 65536 {similarity}"] = check_score(
                what, got, fused_direction_score_plain(*taps, similarity), similarity, tol, tol)
        rows = [x.reshape(p * b * h, s, d) for x in (taps[0], taps[3], taps[4], taps[1], taps[2])]
        got, took = _counted(cross_self_partials, lambda: torch.stack(cross_self_partials(*rows)))
        ref = torch.stack(readout.cross_self_partials_plain(*rows))
        rtol = DOMAIN_PARTIAL_RTOL[dtype]
        what = f"K3 partials of {p * b * h} rows {name} ({took} launches)"
        _domain_check(what, got, ref, (3, p * b * h), took, 2, (0.0, rtol))
        cut = plan.slices[1][0]
        out[f"k3 {name} N 65536 boundary"] = _boundary(
            what, got.t(), ref.t(), (cut - 2, cut - 1, cut), (0.0, rtol))
        del taps, rows, got, ref
        torch.cuda.empty_cache()


def _domain_k2(gen, out: dict) -> None:
    def rand(shape, scale, dtype):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    def weights(c, dtype):
        return (rand((8 * c, c), c**-0.5, dtype), rand((8 * c,), 0.1, dtype),
                rand((c, 4 * c), (4 * c) ** -0.5, dtype), rand((c,), 0.1, dtype))

    for dtype in (torch.float32, torch.bfloat16):
        name, tol = _dtype_name(dtype), DOMAIN_K2_TOL[dtype]
        for c in DOMAIN_K2_DIMS:
            args = (rand((DOMAIN_K2_ROWS, c), 1.0, dtype), *weights(c, dtype))
            got, took = _counted(fused_geglu_ff, lambda: fused_geglu_ff(*args))
            out[f"k2 {name} C {c}"] = _domain_check(
                f"K2 {(DOMAIN_K2_ROWS, c)} {name} (padded to {c + -c % 32})", got,
                fused_geglu_ff_plain(*args), (DOMAIN_K2_ROWS, c), took, 1, tol)
            print(f"  K2 {(DOMAIN_K2_ROWS, c)} {name}, C zero-padded to {c + -c % 32} with the "
                  f"weights: max|kernel - plain| = {out[f'k2 {name} C {c}']:.3e} (atol = rtol = "
                  f"{tol[0]}), 1 launch", flush=True)
        n, c = DOMAIN_K2_SPLIT
        args = (rand((n, c), 1.0, dtype), *weights(c, dtype))
        plan = kff.launch_plan((n, c), dtype)
        got, took = _counted(fused_geglu_ff, lambda: fused_geglu_ff(*args))
        ref = fused_geglu_ff_plain(*args)
        what = f"K2 {DOMAIN_K2_SPLIT} {name} (ceil(N / 64) > 65535, {took} launches)"
        if len(plan.slices) != 2:
            raise SystemExit(f"{what}: the plan has {len(plan.slices)} slices, not 2")
        err = _domain_check(what, got, ref, (n, c), took, 2, tol)
        cut = plan.slices[1][0]
        edge = _boundary(what, got, ref, (cut - 2, cut - 1, cut, cut + 1, n - 1), tol)
        out[f"k2 {name} N {n}"] = {"max_abs_err": err, "boundary_err": edge, "launches": took}
        print(f"  {what}: max|kernel - plain| = {err:.3e} over the output", flush=True)
        del args, got, ref
        torch.cuda.empty_cache()


def _domain_routes(gen, out: dict) -> None:
    """One call a kernel through its route (``ops.attention.sdpa``, ``GEGLUFeedForward``,
    ``metrics.readout.cross_attention_score``) at a shape off the granule, in both dtypes."""
    for dtype in (torch.float32, torch.bfloat16):
        name = _dtype_name(dtype)
        q, k, v = (torch.randn((1, 2, 256, 20), generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        got, took = _counted(fused_self_attention, lambda: tattn.sdpa(q, k, v))
        out[f"route sdpa {name}"] = _domain_check(
            f"ops.attention.sdpa (1, 2, 256, 20) {name}", got, fused_self_attention_plain(q, k, v),
            (1, 2, 256, 20), took, 1, DOMAIN_K1_TOL[dtype])
        ff = GEGLUFeedForward(40).to("cuda", dtype)
        with torch.no_grad():
            for param in ff.parameters():
                param.copy_(torch.randn(param.shape, generator=gen, device="cuda") * 0.1)
            x = torch.randn((2, 256, 40), generator=gen, device="cuda").to(dtype)
            got, took = _counted(fused_geglu_ff, lambda: ff(x))
            ref = fused_geglu_ff_plain(x.reshape(512, 40), ff.proj_in.weight, ff.proj_in.bias,
                                       ff.proj_out.weight, ff.proj_out.bias).reshape(2, 256, 40)
        out[f"route GEGLUFeedForward {name}"] = _domain_check(
            f"GEGLUFeedForward(40) on (2, 256, 40) {name}", got, ref, (2, 256, 40), took, 1,
            DOMAIN_K2_TOL[dtype])
        qa, ka, va, kb, vb = _domain_taps((1, 1, 2, 512, 20), dtype, gen)
        qb = qa + 0.3 * torch.randn(qa.shape, generator=gen, device="cuda").to(dtype)
        tol = DOMAIN_K3_TOL[dtype]
        for similarity in ("cosine", "mse"):
            got, took = _counted(cross_self_partials, lambda: cross_attention_score(
                qa, ka, va, qb, kb, vb, similarity))
            if took != 2:
                raise SystemExit(f"cross_attention_score {name}: {took} K3 launches, not 2")
            ref = (fused_direction_score_plain(qa, ka, va, kb, vb, similarity)
                   + fused_direction_score_plain(qb, kb, vb, ka, va, similarity)) / 2.0
            out[f"route cross_attention_score {name} {similarity}"] = check_score(
                f"metrics.readout.cross_attention_score (1, 1, 2, 512, 20) {name} {similarity} "
                "(2 launches)", got, ref, similarity, tol, tol)
    print("  through the routes: sdpa 1 K1, GEGLUFeedForward 1 K2, cross_attention_score 2 K3 "
          f"launches a call; max|kernel - plain| "
          f"{max(v for k, v in out.items() if k.startswith('route')):.3e}", flush=True)


def _domain_grad(gen, out: dict) -> None:
    """K1's gradient at D 36 through ``FusedSelfAttention`` against the plain version's."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, g = (torch.randn(DOMAIN_K1_GRAD, generator=gen, device="cuda").to(dtype)
                      for _ in range(4))
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        got, took = _counted(fused_self_attention, lambda: fused_self_attention(*qkv))
        if type(got.grad_fn).__name__ != "FusedSelfAttentionBackward" or took != 1:
            raise SystemExit(f"K1 {DOMAIN_K1_GRAD} under grad: grad_fn "
                             f"{type(got.grad_fn).__name__}, {took} launch(es)")
        saved = [tuple(t.shape) for t in got.grad_fn.saved_tensors]
        if saved != [DOMAIN_K1_GRAD] * 3:
            raise SystemExit(f"K1 under grad saved {saved}, not the unpadded q, k, v")
        grads = torch.autograd.grad(got, qkv, g)
        tol = DOMAIN_K1_TOL[dtype]
        what = f"K1 {DOMAIN_K1_GRAD} {_dtype_name(dtype)} under autograd"
        with torch.no_grad():
            err = _domain_check(f"{what} forward", got, fused_self_attention_plain(q, k, v),
                                DOMAIN_K1_GRAD, took, 1, tol)
        ref_qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = torch.autograd.grad(fused_self_attention_plain(*ref_qkv), ref_qkv, g)
        grad_err = max(check_close(f"{what} grad d{x}", a, b, *tol)
                       for x, a, b in zip("qkv", grads, ref))
        out[f"grad {_dtype_name(dtype)}"] = {"max_abs_err": err, "grad_max_abs_err": grad_err}


def kernel_domain_phase(gen) -> dict:
    phase("K1-K3 at the shapes their kernels take only through the wrapper: D % 8 != 0 (K1 at D "
          f"{DOMAIN_K1_DIMS}, K3 at {DOMAIN_K3_DIMS}) and C % 32 != 0 (K2 at {DOMAIN_K2_DIMS}) "
          "zero-padded, more rows than the grid's 65535 in two launches, both dtypes and K1's "
          "bf16_probs mode, against the plain versions at the K1-K3 phases' limits; one call a "
          "kernel through its route; K1's gradient at D 36")
    t0 = time.perf_counter()
    out = {}
    _domain_k1(gen, out)
    _domain_k3(gen, out)
    _domain_k2(gen, out)
    _domain_routes(gen, out)
    _domain_grad(gen, out)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase done in {out['seconds']:.1f} s", flush=True)
    return out


def tiny_train_phase() -> None:
    phase("one DiT training step at tiny width in float32, TF32 off: card vs CPU from one seeded "
          "tree with injected noise, t (5, 617) and label drop (loss and MSE within 1e-5 "
          "relative; each gradient within 1e-4 of its leaf's largest entry; the card's AdamW "
          "step and EMA within 2e-7 of the CPU's AdamW on the card's own gradients)")
    rng = np.random.default_rng(2337)
    cfg, vae_cfg = DiTConfig(**TINY_TRAIN), VAEConfig.tiny()
    trees = {"dit": _random_tree(lambda: DiT(cfg), "dit", rng),
             "vae": _random_tree(lambda: Encoder(vae_cfg), "vae", rng)}
    pixels = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    draws = dict(latent_noise=rng.standard_normal((2, 32, 32, 4)).astype(np.float32),
                 noise=rng.standard_normal((2, 32, 32, 4)).astype(np.float32),
                 t=np.array([5, 617]), drop=np.array([False, True]))
    trainers, metrics, before = {}, {}, None
    with tf32_off():
        for device in ("cuda", "cpu"):
            trainer = DiTTrainer(TrainConfig(image_size=64), dit_cfg=cfg, vae_cfg=vae_cfg,
                                 vae_params=trees["vae"], device=device)
            trainer.load_params(trees["dit"])
            if device == "cuda":
                before = [p.detach().cpu().clone() for p in trainer.model.parameters()]
            kernels.reset_launch_counts()
            metrics[device] = trainer.train_step(pixels, np.array([4, 7]), **draws)
            counts = kernels.launch_counts()
            if device == "cuda":
                print(f"  launches of the card's step: {counts}")
                if counts != TINY_TRAIN_STEP:
                    raise SystemExit(f"tiny training step: expected launches {TINY_TRAIN_STEP}")
            trainers[device] = trainer
    card, cpu = trainers["cuda"], trainers["cpu"]
    for key in ("loss", "mse"):
        gap = abs(metrics["cuda"][key] / metrics["cpu"][key] - 1)
        print(f"  {key}: card {metrics['cuda'][key]:.7f}, cpu {metrics['cpu'][key]:.7f}, "
              f"relative gap {gap:.3e}")
        if not (np.isfinite(metrics["cuda"][key]) and gap <= 1e-5):
            raise SystemExit(f"tiny training step: the card's {key} disagrees with the CPU's")
    worst = 0.0
    for (name, p), q in zip(card.model.named_parameters(), cpu.model.parameters()):
        gap = (p.grad.cpu() - q.grad).abs().max().item() / q.grad.abs().max().clamp(min=1e-30)
        worst = max(worst, float(gap))
        if not gap <= 1e-4:
            raise SystemExit(f"tiny training step: gradient of {name} off by {gap:.3e} of its "
                             "largest entry")
    # the optimizer and the EMA, held apart from the gradients: the first Adam step moves each
    # weight by about lr * sign(g), so a gradient entry near zero that rounds to the other sign
    # on the other device moves its weight by up to 2 lr; CPU AdamW on the card's gradients,
    # within two float32 ulps of the largest weights (~0.5; the two AdamW implementations round
    # the update in another order)
    ref = [p.clone().requires_grad_() for p in before]
    for r, p in zip(ref, card.model.parameters()):
        r.grad = p.grad.cpu()
    torch.optim.AdamW(ref, lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0).step()
    d = card.cfg.ema_decay
    opt_gap = max((p.detach().cpu() - r.detach()).abs().max().item()
                  for p, r in zip(card.model.parameters(), ref))
    ema_gap = max((e.cpu() - (b * d + r.detach() * (1 - d))).abs().max().item()
                  for e, b, r in zip(card.ema.parameters(), before, ref))
    print(f"  gradients: worst leaf gap {worst:.3e} of its largest entry; AdamW step "
          f"{opt_gap:.3e}; EMA {ema_gap:.3e}", flush=True)
    if not (opt_gap <= 2e-7 and ema_gap <= 2e-7):
        raise SystemExit("tiny training step: the card's AdamW or EMA disagrees with the CPU's")


def _train_tree(root: str) -> str:
    """An ImageFolder tree of 96 random JPEGs, 48 in each of 2 class folders, at 320 x 288."""
    from PIL import Image

    rng = np.random.default_rng(2338)
    base = os.path.join(root, "train")
    for cls in ("n01440764", "n01443537"):
        os.makedirs(os.path.join(base, cls))
        for i in range(48):
            Image.fromarray(rng.integers(0, 256, (288, 320, 3), dtype=np.uint8)).save(
                os.path.join(base, cls, f"{i:03d}.JPEG"), format="JPEG", quality=90)
    return base


@contextlib.contextmanager
def _watched(cls, method: str):
    """Record every call of ``cls.method`` while the block runs: its wall time in ms, ended by a
    synchronize, the kernels' launches within it, and what it returned if that is a dict or an
    array."""
    calls, orig = [], getattr(cls, method)

    def wrapped(self, *args, **kw):
        before = kernels.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(self, *args, **kw)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        calls.append({"ms": (time.perf_counter() - t0) * 1e3, "out": out if isinstance(
            out, (dict, np.ndarray)) else None, "counts": {k: after[k] - before[k] for k in after}})
        return out

    setattr(cls, method, wrapped)
    try:
        yield calls
    finally:
        setattr(cls, method, orig)


@contextlib.contextmanager
def _grad_sums():
    """While the block runs, every ``mesh.all_reduce_sum_`` call (the trainer's gradient sum)
    is timed between two synchronizes, and the first call's gradients are sampled: the first
    GRAD_SAMPLE entries of each parameter's, before the sum (this rank's own) and after it."""
    real, got = mesh.all_reduce_sum_, {"ms": [], "own": None, "summed": None}

    def sample(tensors):
        return [t.detach().reshape(-1)[:GRAD_SAMPLE].float().cpu() for t in tensors[:-1]]

    def timed(tensors):
        tensors = list(tensors)  # the parameters' gradients, then the loss sums
        first = got["own"] is None
        if first:
            got["own"] = sample(tensors)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real(tensors)
        torch.cuda.synchronize()
        got["ms"].append((time.perf_counter() - t0) * 1e3)
        if first:
            got["summed"] = sample(tensors)

    mesh.all_reduce_sum_ = timed
    try:
        yield got
    finally:
        mesh.all_reduce_sum_ = real


def _grad_gap(got: list, want: list) -> float:
    """max over the leaves of max |got - want| / max |want| (sampled leaves, in order)."""
    return max(float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))
               for a, b in zip(got, want, strict=True))


def _train_run(mode: str, argv: list, expected: dict, card_line: str,
               keep: bool = False, grads: bool = False) -> dict:
    """One ``dit_train.main(argv)`` on the card with the launch counts set to 0 just before it:
    every step's launches held to ``expected``, the losses finite; step time (the median over
    the steps after the first), images/s and peak device memory, with nothing of an earlier
    run left on the card. ``keep`` returns the trainer under ``"trainer"``, ``grads`` the first
    step's sampled gradients under ``"grads"`` (:func:`_grad_sums`)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with _watched(DiTTrainer, "train_step") as steps, _grad_sums() as sums:
        trainer = dit_train.main(argv)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, step in enumerate(steps):
        if step["counts"] != expected:
            raise SystemExit(f"dit_train {mode}: step {i} launched {step['counts']}, expected "
                             f"{expected}")
    losses = [step["out"]["loss"] for step in steps]
    if not np.isfinite(losses).all():
        raise SystemExit(f"dit_train {mode}: losses {losses} are not finite")
    step_ms = statistics.median(s["ms"] for s in steps[1:]) if len(steps) > 1 else steps[0]["ms"]
    out = {"steps": len(steps), "trainer_step": trainer.step, "losses": losses,
           "first_step_ms": steps[0]["ms"],
           "step_ms": step_ms, "images_per_s": TRAIN_BATCH / step_ms * 1e3, "peak_gib": peak,
           "wall_s": wall, "counts": counts}
    print(f"  {mode}: {len(steps)} steps to trainer step {trainer.step}, losses {losses}, "
          f"launches {counts}; "
          f"step {step_ms:.1f} ms (first {steps[0]['ms']:.1f}), "
          f"{out['images_per_s']:.2f} images/s, peak {peak:.2f} GiB, {wall:.1f} s in all, on "
          f"{card_line}", flush=True)
    if keep:
        out["trainer"] = trainer
    if grads:
        out["grads"] = sums["summed"]
    return out


def train_cli_phase(tmp: str, card_line: str) -> dict:
    phase(f"DiT training CLI at full width: dit_train --model DiT-XL/2 --image_size 256 "
          f"--global_batch_size {TRAIN_BATCH} over 96 random JPEGs, float32 (4 steps, checkpoint "
          "every 2), --resume from step 2, --bf16 (3 steps), --remat (2 steps, random VAE); "
          "28 K1 launches a step (56 with --remat) and 28 of its backward kernel, none of K2-K4")
    data = _train_tree(tmp)
    rng = np.random.default_rng(2339)
    t0 = time.perf_counter()
    vae_npz = os.path.join(tmp, "sd_vae.npz")
    # the SD VAE at its published widths, drawn at the JAX init's scale (N(0, 0.02) weights)
    save_params(vae_npz, {
        "vae": _random_tree(lambda: Encoder(VAEConfig.sd()), "vae", rng, scale=0.02),
        "vae_decoder": _random_tree(lambda: Decoder(VAEConfig.sd()), "vae_decoder", rng,
                                    scale=0.02)})
    print(f"  wrote the SD VAE .npz (vae, vae_decoder) in {time.perf_counter() - t0:.1f} s, "
          f"{os.path.getsize(vae_npz) / 2**20:.0f} MiB", flush=True)
    base = ["--data_path", data, "--model", "DiT-XL/2", "--image_size", str(TRAIN_SIZE),
            "--global_batch_size", str(TRAIN_BATCH), "--log_every", "1"]
    f32_dir = os.path.join(tmp, "results_f32")
    runs = {"float32": _train_run("float32", base + [
        "--results_dir", f32_dir, "--max_steps", "4", "--ckpt_every", "2",
        "--vae_weights", vae_npz], TRAIN_STEP, card_line, grads=True)}
    ckpt2 = os.path.join(f32_dir, "ckpt_0000002")
    runs["resume"] = _train_run("resume", base + [
        "--results_dir", f32_dir, "--max_steps", "2", "--ckpt_every", "1000",
        "--vae_weights", vae_npz, "--resume", ckpt2], TRAIN_STEP, card_line)
    log = open(os.path.join(f32_dir, "log.txt")).read()
    if (runs["float32"]["trainer_step"] != 4 or runs["resume"]["trainer_step"] != 4
            or "at step 2" not in log or log.count("(step=0000003)") != 2):
        raise SystemExit("dit_train --resume: the step count did not continue from step 2")
    runs["bf16"] = _train_run("bf16", base + [
        "--results_dir", os.path.join(tmp, "results_bf16"), "--max_steps", "3",
        "--ckpt_every", "1000", "--vae_weights", vae_npz, "--bf16"], TRAIN_STEP, card_line,
        keep=True)
    bf16_trainer = runs["bf16"].pop("trainer")
    if any(p.dtype != torch.float32 for p in bf16_trainer.model.parameters()):
        raise SystemExit("dit_train --bf16: the master weights are not float32")
    pixels, labels = next(iter(ImageFolderDataset(data, TRAIN_SIZE, seed=1).epoch_batches(
        TRAIN_BATCH)))
    profile_call(lambda: bf16_trainer.train_step(pixels, labels),
                 f"DiT-XL/2 bf16 training step at batch {TRAIN_BATCH}, 256 px")
    del bf16_trainer
    runs["remat"] = _train_run("remat", base + [
        "--results_dir", os.path.join(tmp, "results_remat"), "--max_steps", "2",
        "--ckpt_every", "1000", "--remat"], REMAT_STEP, card_line)
    gc.collect()
    torch.cuda.empty_cache()
    return {"runs": runs, "ckpt": os.path.join(f32_dir, "ckpt_0000004"), "ckpt2": ckpt2,
            "vae_npz": vae_npz, "data": data, "base": base}


def sample_cli_phase(tmp: str, train: dict, card_line: str) -> dict:
    phase(f"DiT sampling CLI at full width from the training checkpoint: dit_sample --model "
          f"DiT-XL/2 --image_size 256 on the 8 default labels, CFG 4.0, {SAMPLE_STEPS} steps "
          "(ancestral, --ddim) and --num_fid_samples 16 --per_batch 8, decoded by the SD VAE "
          "decoder; 28 K1 launches per denoising step, none from the decoder")
    base = ["--ckpt", train["ckpt"], "--vae_weights", train["vae_npz"], "--model", "DiT-XL/2",
            "--image_size", str(TRAIN_SIZE), "--cfg_scale", "4.0",
            "--num_sampling_steps", str(SAMPLE_STEPS)]
    out = {}
    for mode, extra, path in (("ancestral", [], "grid.png"), ("ddim", ["--ddim"], "grid_ddim.png"),
                              ("fid", ["--num_fid_samples", "16", "--per_batch", "8"],
                               "fid.npz")):
        target = os.path.join(tmp, path)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with _watched(DiTTrainer, "sample") as calls:
            dit_sample.main(base + extra + ["--out", target])
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        want = {**NONE, "fused_self_attention": 28 * SAMPLE_STEPS * len(calls)}
        if counts != want or any(c["counts"] != {**NONE, "fused_self_attention":
                                                  28 * SAMPLE_STEPS} for c in calls):
            raise SystemExit(f"dit_sample {mode}: launches {counts}, expected {want}")
        if mode == "fid":
            with np.load(target) as f:
                arr = f["arr_0"]
            if arr.shape != (16, TRAIN_SIZE, TRAIN_SIZE, 3) or arr.dtype != np.uint8:
                raise SystemExit(f"dit_sample --num_fid_samples: {arr.shape} {arr.dtype}")
            images = 16
        else:
            from PIL import Image

            with Image.open(target) as img:
                if img.size != (4 * TRAIN_SIZE, 2 * TRAIN_SIZE):
                    raise SystemExit(f"dit_sample {mode}: grid of {img.size}")
            images = 8
        sample_ms = sum(c["ms"] for c in calls)
        peak = torch.cuda.max_memory_allocated() / 2**30
        out[mode] = {"calls": len(calls), "counts": counts, "images": calls[0]["out"],
                     "ms_per_step": sample_ms / (SAMPLE_STEPS * len(calls)),
                     "images_per_s": images / sample_ms * 1e3, "peak_gib": peak, "wall_s": wall}
        print(f"  {mode}: {len(calls)} sample call(s), launches {counts}; "
              f"{out[mode]['ms_per_step']:.1f} ms per denoising step (decode included), "
              f"{out[mode]['images_per_s']:.3f} images/s, peak {peak:.2f} GiB, {wall:.1f} s "
              f"in all, on {card_line}", flush=True)
    return out


# ---------------------------------------------------------------------------
# SAM masks, the scoring service and the retrieval tool
# ---------------------------------------------------------------------------

SAM_TOL = 1e-4  # tiny SAM, card vs CPU in float32 with TF32 off: logits and IoU, atol = rtol
# SAM ViT-H at 1024 px, float32 vs float64 on the card: |d| <= SAM_F64_TOL * max |logit64| over
# the multimask logits, and as much of the largest IoU prediction on the IoUs
SAM_F64_TOL = 1e-3
# the SD-1.5 scorer's scores through the service or ``rank``'s cached route against its own
# score_batch / pair route on the same pixels: cuDNN picks its algorithms per batch shape, and
# cached and fresh scores already differ by 1.27e-4 (PERF.md)
SERVED_TOL = 1e-3
SERVE_FLAGS = ["--metric", "diffsim", "--image_size", "512", "--prompt", CUTE["prompt"],
               "--target_block", CUTE["target_block"], "--target_layer", "0", "--target_step",
               str(CUTE["target_step"]), "--similarity", CUTE["similarity"], "--seed",
               str(CUTE["seed"])]
SERVE_BATCH = 2  # --batch_size: rounds of at most 4 pairs
SAM_SIZES = ((640, 480), (480, 640), (1024, 1024), (800, 450))  # (w, h) of the ViT-H images


def _sam_forward(model, pixels, coords, labels, device):
    with torch.no_grad():
        masks, iou = model.predict(
            torch.from_numpy(pixels).to(device, next(model.parameters()).dtype),
            torch.from_numpy(coords).to(device), torch.from_numpy(labels).to(device))
    return masks, iou


def sam_tiny_phase() -> None:
    phase(f"SAM at tiny width in float32, TF32 off: card vs CPU on one seeded tree bridged to "
          f"both (predict's mask logits and IoU within atol = rtol = {SAM_TOL:g}; SamMasking's "
          "mattes of two aspect ratios equal except where the CPU's resampled logit is within "
          "that of 0); no K1-K4 launch")
    rng = np.random.default_rng(12)
    tree = _random_tree(lambda: Sam(SamConfig.tiny()), "sam", rng, scale=0.3)
    pixels = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    coords = np.asarray([[[10.0, 20.0], [5.0, 7.0]], [[31.0, 0.0], [16.0, 16.0]]], np.float32)
    labels = np.asarray([[1, 0], [2, 3]], np.int64)
    with tf32_off():
        maskings = {d: SamMasking(tree, SamConfig.tiny(), device=d) for d in ("cuda", "cpu")}
        kernels.reset_launch_counts()
        out = {d: _sam_forward(m.model, pixels, coords, labels, d) for d, m in maskings.items()}
        for i, what in enumerate(("mask logits", "IoU")):
            card, cpu = out["cuda"][i].cpu(), out["cpu"][i]
            print(f"  tiny SAM predict, {what}: max |card - CPU| = "
                  f"{(card - cpu).abs().max().item():.3e} of max {cpu.abs().max().item():.3e}",
                  flush=True)
            if not torch.allclose(card, cpu, atol=SAM_TOL, rtol=SAM_TOL):
                raise SystemExit(f"tiny SAM: the card's {what} differ from the CPU's")
        for size in ((48, 40), (24, 56)):
            img = _salient_image(rng, size)
            card, cpu = (np.asarray(maskings[d](img))[..., 3] for d in ("cuda", "cpu"))
            m = maskings["cpu"]
            px, co, lb, resized = m.inputs(img)
            logits = resampled_logits(m.best_logits(px, co, lb), m.cfg, resized, size)
            differ = card != cpu
            print(f"  tiny SAM matte {size[0]}x{size[1]}: foreground {(cpu > 0).mean():.3f}, "
                  f"{int(differ.sum())} pixels differ, all where |logit| <= {SAM_TOL:g}: "
                  f"{not differ[np.abs(logits) > SAM_TOL].any()}", flush=True)
            if differ[np.abs(logits) > SAM_TOL].any():
                raise SystemExit("tiny SAM: the card's matte differs from the CPU's")
        counts = kernels.launch_counts()
    if counts != NONE:
        raise SystemExit(f"tiny SAM launched {counts}: SAM runs on the math path")


def sam_vit_h_phase(card_line: str) -> dict:
    phase("SAM ViT-H at full width, 1024 px (1280 wide, 32 blocks, 16 heads of 80, global layers "
          "7/15/23/31, windows of 14 over the 64 x 64 grid padded to 70), random weights drawn "
          f"on the card, float32: SamMasking on {len(SAM_SIZES)} images of different aspect "
          "ratios, each mask's time, the peak device memory, no K1-K4 launch; one image's "
          f"logits against the same module in float64 (|d| <= {SAM_F64_TOL:g} x max |logit|)")
    masking = SamMasking(None, SamConfig.vit_h(), device="cuda")
    weights = sum(p.numel() * p.element_size() for p in masking.model.parameters()) / 2**30
    rng = np.random.default_rng(13)
    images = [_salient_image(rng, size) for size in SAM_SIZES]
    masking(images[0])  # warm-up: cuBLAS's handles and the allocator's pools
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    walls = []
    for img in images:
        t0 = time.perf_counter()
        rgba = masking(img)
        walls.append((time.perf_counter() - t0) * 1e3)
        fg = (np.asarray(rgba)[..., 3] > 0).mean()
        if rgba.mode != "RGBA" or rgba.size != img.size:
            raise SystemExit(f"SAM ViT-H: a {rgba.mode} matte of {rgba.size} for {img.size}")
        print(f"  {img.size[0]}x{img.size[1]}: {walls[-1]:.1f} ms a mask, host work in; "
              f"foreground {fg:.3f}", flush=True)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if counts != NONE:
        raise SystemExit(f"SAM ViT-H launched {counts}: SAM runs on the math path")
    px, co, lb, resized = masking.inputs(images[0])
    device_ms_, _ = device_ms(lambda: _sam_forward(masking.model, px, co, lb, "cuda"), reps=5,
                              warmup=1)
    profile_call(lambda: _sam_forward(masking.model, px, co, lb, "cuda"), "SAM ViT-H predict")
    masks32, iou32 = _sam_forward(masking.model, px, co, lb, "cuda")
    model64 = copy.deepcopy(masking.model).double()
    masks64, iou64 = _sam_forward(model64, px, co, lb, "cuda")
    del model64
    torch.cuda.empty_cache()
    err = (masks32.double() - masks64).abs().max().item()
    scale = masks64.abs().max().item()
    iou_err = (iou32.double() - iou64).abs().max().item()
    best32, best64 = int(iou32.argmax()), int(iou64.argmax())
    size = images[0].size
    lg32, lg64 = (resampled_logits(m[0, b].float().cpu().numpy(), masking.cfg, resized, size)
                  for m, b in ((masks32, best32), (masks64, best64)))
    flips = int(((lg32 > 0) != (lg64 > 0)).sum())
    print(f"  float32 vs float64 on the card: max |d logit| {err:.3e} of max |logit| "
          f"{scale:.3e} ({err / scale:.3e}), max |d IoU| {iou_err:.3e}; best mask {best32} / "
          f"{best64}; {flips} of {size[0] * size[1]} mask pixels flip", flush=True)
    if not (err <= SAM_F64_TOL * scale and iou_err <= SAM_F64_TOL * iou64.abs().max().item()):
        raise SystemExit("SAM ViT-H: float32 is off its float64 run")
    print(f"  SAM ViT-H on {card_line}: {statistics.median(walls):.1f} ms a mask (median of "
          f"{len(walls)}, host work in; predict {device_ms_:.1f} ms on the device by "
          f"{TIMING['method']}), peak device memory {peak:.2f} GiB with {weights:.2f} GiB of "
          "weights", flush=True)
    out = {"mask_ms": walls, "predict_device_ms": device_ms_, "peak_gib": peak,
           "weights_gib": weights, "f64_rel_err": err / scale, "flipped_pixels": flips}
    del masking
    torch.cuda.empty_cache()
    return out


def published_sam_sd(cfg, gen) -> dict:
    """A state dict of the published ``sam_vit_*.pth`` names and shapes at ``cfg``'s widths (the
    repo's torch mirror of the layout, on the meta device): matrices N(0, 0.02^2), norm weights
    one, biases zero."""
    from tools.torch_sam import Sam as PublishedSam

    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in PublishedSam(
            image_size=cfg.image_size, patch=cfg.patch, encoder_dim=cfg.encoder_dim,
            encoder_depth=cfg.encoder_depth, encoder_heads=cfg.encoder_heads,
            global_attn=cfg.global_attn, window=cfg.window, prompt_dim=cfg.prompt_dim,
            decoder_heads=cfg.decoder_heads, decoder_depth=cfg.decoder_depth,
            decoder_mlp=cfg.decoder_mlp).state_dict().items()}
    sd = {}
    for name, shape in shapes.items():
        if name.endswith("bias"):
            sd[name] = torch.zeros(shape)
        elif len(shape) == 1:
            sd[name] = torch.ones(shape)
        else:
            sd[name] = torch.randn(shape, generator=gen) * 0.02
    return sd


def sam_cli_phase(tree: str) -> dict:
    phase("convert sam and the CLI with SAM masks: python -m diffsim_tpu_torch.cli.convert sam "
          "on a torch.save sam_vit_b checkpoint of the published names and widths (jax, "
          "safetensors and ml_dtypes made to raise on import), then cute --preset cute "
          "--use_mask --sam_weights at full SD-1.5 width, 512 px, over the 36 JPEGs")
    plan = benchmarks.cute(tree, 2334)
    calls = -(-len(plan) // CLI_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        sd = published_sam_sd(SamConfig.vit_b(), torch.Generator().manual_seed(2338))
        ckpt, npz = os.path.join(tmp, "sam_vit_b.pth"), os.path.join(tmp, "sam.npz")
        torch.save(sd, ckpt)
        cmd = [sys.executable, "-c", CONVERT_CLI, "sam", "--model", ckpt, "--out", npz]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                             capture_output=True, text=True, timeout=600)
        convert_s = time.perf_counter() - t0
        print(f"  convert sam --model sam_vit_b.pth: rc {res.returncode} in {convert_s:.1f} s: "
              f"{res.stdout.strip()}", flush=True)
        if res.returncode:
            print(res.stderr[-4000:], flush=True)
            raise SystemExit("the convert CLI failed on the SAM checkpoint")
        params = registry._load_params(npz)
        qkv = params["image_encoder"]["blocks"][3]["attn"]["qkv"]["w"]
        want = sd["image_encoder.blocks.3.attn.qkv.weight"].to(torch.bfloat16).float().T
        convt = params["mask_decoder"]["upscale"]["convt1"]["w"]
        want_t = sd["mask_decoder.output_upscaling.0.weight"].to(torch.bfloat16).float()
        if (infer_config(params) != SamConfig.vit_b() or not np.array_equal(qkv, want.numpy())
                or not np.array_equal(convt, want_t.permute(2, 3, 0, 1).numpy())):
            raise SystemExit("convert sam: the .npz is not the checkpoint's ViT-B in bf16")
        report, adapter, scores, counts, _, wall = _cli_run(
            "cli_sam_masks", tree, os.path.join(tmp, "sam.jsonl"), "--use_mask",
            "--sam_weights", npz)
    want = {k: v * calls for k, v in SD15_CALL.items()}
    if report.total != len(plan) or sorted(scores) != list(range(len(plan))):
        raise SystemExit(f"cli_sam_masks: scored {report.total} of {len(plan)} comparisons")
    if counts != want:
        raise SystemExit(f"cli_sam_masks: launched {counts}, expected {want} ({calls} calls)")
    _check_scores("cli_sam_masks", np.array(list(scores.values())))
    del adapter
    torch.cuda.empty_cache()
    return {"counts": counts, "wall_s": wall, "pairs_per_s": 2 * len(plan) / wall,
            "convert_s": convert_s}


def _post(port: int, payload: dict, path: str = "/score"):
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def serve_phase(tree: str, card_line: str) -> dict:
    phase("the scoring service at full SD-1.5 width, 512 px: make_server on an ephemeral "
          "localhost port in a thread, max_wait_ms 200, --batch_size 2 (rounds of at most 4 "
          "pairs); 3 concurrent clients by path and by base64; an oversize request chunked; "
          f"/healthz; a bad path 400; each request's scores within {SERVED_TOL:g} of the "
          "scorer's own score_batch on the same pixels")
    import base64
    import threading
    import urllib.error
    import urllib.request

    from PIL import Image

    paths = sorted(os.path.join(d, f) for d, _, fs in os.walk(tree) for f in fs)[:6]
    server, batcher = serve.make_server(
        arg_parse(SERVE_FLAGS + ["--batch_size", str(SERVE_BATCH)]), 0, max_wait_ms=200.0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    rounds = []
    real = batcher._score

    def counted(pix_a, pix_b, prompts):  # the batcher thread alone touches the card
        before = kernels.launch_counts()
        scores = real(pix_a, pix_b, prompts)
        after = kernels.launch_counts()
        rounds.append((len(prompts), {k: after[k] - before[k] for k in after}))
        return scores

    batcher._score = counted
    b64 = {p: {"b64": base64.b64encode(open(p, "rb").read()).decode()} for p in paths}
    prompt = CUTE["prompt"]
    try:
        _post(port, {"pairs": [[paths[0], paths[1]]], "prompt": prompt})  # warm-up round
        rounds.clear()
        requests = [[[paths[0], paths[1]]], [[paths[2], b64[paths[3]]]],
                    [[b64[paths[4]], paths[5]], [paths[1], paths[4]]]]
        results, latency = [None] * 3, [None] * 3

        def client(i):
            t0 = time.perf_counter()
            results[i] = _post(port, {"pairs": requests[i], "prompt": prompt})["scores"]
            latency[i] = (time.perf_counter() - t0) * 1e3

        clients = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=600)
        if any(t.is_alive() for t in clients) or any(r is None for r in results):
            raise SystemExit(f"serve: a client got no answer: {results}")
        burst = list(rounds)
        if len(burst) >= len(requests):
            raise SystemExit(f"serve: {len(requests)} concurrent requests took {len(burst)} "
                             "rounds, none fused")
        rounds.clear()
        oversize = [[paths[i % 6], paths[(i + 1) % 6]] for i in range(2 * SERVE_BATCH + 2)]
        big = _post(port, {"pairs": oversize, "prompt": prompt})["scores"]
        if [n for n, _ in rounds] != [2 * SERVE_BATCH, 2]:
            raise SystemExit(f"serve: an oversize request of {len(oversize)} pairs took rounds "
                             f"{[n for n, _ in rounds]}")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        try:
            _post(port, {"pairs": [[paths[0], os.path.join(tree, "missing.png")]]})
            raise SystemExit("serve: a bad path was answered")
        except urllib.error.HTTPError as err:
            if err.code != 400:
                raise SystemExit(f"serve: a bad path got HTTP {err.code}, not 400")
        after_bad = _post(port, {"pairs": [[paths[2], paths[3]]], "prompt": prompt})["scores"]
    finally:
        batcher._score = real
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    if not health.get("ok") or health.get("metric") != "diffsim":
        raise SystemExit(f"serve: /healthz answered {health}")

    def pix(spec):
        path = spec if isinstance(spec, str) else next(p for p in paths if b64[p] is spec)
        return process_image_u8(Image.open(path), 512)

    gaps = []
    for pairs, got in [*zip(requests, results), (oversize, big), ([[paths[2], paths[3]]],
                                                                  after_bad)]:
        ref = real(np.concatenate([pix(a) for a, _ in pairs]),
                   np.concatenate([pix(b) for _, b in pairs]), [prompt] * len(pairs))
        gaps.append(float(np.abs(np.asarray(got) - ref).max()))
        _check_scores("serve", np.asarray(got))
    per_round = [c for _, c in burst]
    print(f"  served on {card_line}: the burst of 3 requests (4 pairs) in {len(burst)} round(s) "
          f"of {[n for n, _ in burst]} pairs, launches a round {per_round}; request latency p50 "
          f"{statistics.median(latency):.1f} ms, max {max(latency):.1f} ms (information); the "
          f"oversize request in rounds of {2 * SERVE_BATCH} and 2; max |served - score_batch| "
          f"{max(gaps):.3e}", flush=True)
    if max(gaps) > SERVED_TOL:
        raise SystemExit("serve: a served score is off the scorer's score_batch")
    want = {k: v for k, v in SD15_CALL.items()}
    if any(c != want for c in per_round):
        raise SystemExit(f"serve: launches a round {per_round}, expected {want}")
    batcher._score = None  # the batcher thread waits on its queue: let the scorer go
    del server, batcher, real
    gc.collect()
    torch.cuda.empty_cache()
    return {"burst_rounds": [n for n, _ in burst], "launches_round": per_round[0],
            "burst_scores": results, "paths": paths,
            "latency_ms": latency, "max_gap": max(gaps)}


def rank_phase(tree: str, card_line: str) -> dict:
    phase("retrieval rank at full SD-1.5 width, 512 px: 1 query against a gallery of 9 JPEGs "
          "through the moment cache (5 triplets in calls of 4: 10 misses), then the pair route "
          f"(--no_device_cache); scores within {SERVED_TOL:g}, and the rankings agree wherever "
          "two scores are further apart")
    images = sorted(os.path.join(d, f) for d, _, fs in os.walk(tree) for f in fs)
    with tempfile.TemporaryDirectory() as tmp:
        gal, q = os.path.join(tmp, "gallery"), os.path.join(tmp, "query")
        os.makedirs(gal)
        os.makedirs(q)
        for i, src in enumerate(images[:9]):
            shutil.copy(src, os.path.join(gal, f"g{i}.jpg"))
        shutil.copy(images[20], os.path.join(q, "q0.jpg"))
        runs = {}
        for route, extra in (("cached", []), ("pairs", ["--no_device_cache"])):
            out = os.path.join(tmp, route)
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            adapter = retrieval.rank(["--query_path", q, "--gallery_path", gal, "--out_path", out,
                                      *SERVE_FLAGS, "--batch_size", "4", *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            with open(os.path.join(out, "q0.txt")) as f:
                ranked = [(ln.split()[0], float(ln.split()[1])) for ln in f]
            cache = getattr(adapter.scorer, "_moment_cache", None)
            runs[route] = {"ranked": ranked, "counts": counts, "wall_s": wall,
                           "stats": dict(cache.stats) if cache is not None else None}
            print(f"  rank, {route} route: {wall:.2f} s with the scorer's init; launches "
                  f"{counts}; moment cache {runs[route]['stats']}", flush=True)
            del adapter, cache
            torch.cuda.empty_cache()
    cached, pairs = runs["cached"], runs["pairs"]
    if cached["stats"]["misses"] != 10 or cached["stats"]["resident"] != 10:
        raise SystemExit(f"rank: {cached['stats']}, expected 10 misses (1 query, 9 gallery)")
    for route, forwards in (("cached", 2), ("pairs", 3)):  # 5 triplets / 4, 9 pairs / 4
        want = {k: v * forwards for k, v in SD15_CALL.items()}
        if runs[route]["counts"] != want:
            raise SystemExit(f"rank ({route}): launched {runs[route]['counts']}, expected {want}")
    a, b = dict(cached["ranked"]), dict(pairs["ranked"])
    gap = max(abs(a[n] - b[n]) for n in b)
    order_a = [n for n, _ in cached["ranked"]]
    order_b = [n for n, _ in pairs["ranked"]]
    apart = [(x, y) for x in b for y in b if b[x] - b[y] > SERVED_TOL]
    swapped = [(x, y) for x, y in apart if order_a.index(x) > order_a.index(y)]
    print(f"  rank on {card_line}: cached vs pair route max |d| {gap:.3e}; scores "
          f"{min(b.values()):.6f} to {max(b.values()):.6f}; {len(apart)} pairs of gallery images "
          f"further apart than {SERVED_TOL:g}, all in the same order: {not swapped}; order "
          f"{order_a} / {order_b}", flush=True)
    if sorted(a) != sorted(b) or len(a) != 9 or gap > SERVED_TOL or swapped:
        raise SystemExit(f"rank: the routes disagree (gap {gap:.3e}, swapped {swapped})")
    return {"cached_s": cached["wall_s"], "pairs_s": pairs["wall_s"],
            "launches_cached": cached["counts"], "launches_pairs": pairs["counts"], "gap": gap,
            "pairs_apart": len(apart)}


# ---------------------------------------------------------------------------
# several ranks: torchrun at world size 1 (NCCL), and two ranks on the one card over gloo
# ---------------------------------------------------------------------------

RANKS = 2  # the multi-rank phases' ranks, all on cuda:0: this machine has one card
RANKS_TOL = 1e-3  # scores on two ranks against one rank's: the service check's limit
# the gathered scores on two ranks against each rank's block scored again, unsharded, at the
# call's own shape (through the rank's warm moment cache, or on the leader for the service):
# the same kernels on the same inputs, so bit for bit is expected. Random weights put every
# score within about 1.5e-4 of the others, so RANKS_TOL cannot tell a swapped block: each phase
# also prints the gap of the blocks swapped (its control) and fails unless that exceeds this
RANKS_REPLAY_TOL = 1e-6
# the per-step losses of dit_train on two ranks against one rank's at the same global batch:
# float32 (the ranks' GEMMs and convolutions have half the rows, and sum in another order), and
# bf16, where every op rounds to 8 bits
RANKS_LOSS_RTOL = {"float32": 1e-4, "bf16": 5e-3}
# the first step's summed gradients on two ranks against one process's at the same global
# batch: max |d| / the leaf's largest entry, over the first GRAD_SAMPLE entries of every leaf.
# Its control is each rank's own gradient before the sum (what a missing all-reduce would keep)
RANKS_GRAD_TOL = 1e-3
GRAD_SAMPLE = 4096
# rank 0's checkpoint after 2 steps against one process's: the mean |d| over the weights and over
# the EMA. A max |d| cannot fail: AdamW moves each weight by about lr (1e-4) a step whatever the
# gradient, so any two runs from one init lie within 2 lr a step. Its control is the one-process
# checkpoint two steps later (what a checkpoint written at another step would show)
RANKS_CKPT_MEAN_TOL = {"params": 1e-6, "ema": 1e-10}
# dit_sample --ddim on two ranks against one: decoded images in [-1, 1] from the same draws
RANKS_IMAGE_ATOL = 1e-2


def _rank_entry(rank: int, size: int, root: str, job, args) -> None:
    """One rank of a multi-rank phase: a gloo group over a file store, every rank on cuda:0."""
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{root}/store", rank=rank,
                            world_size=size, timeout=mesh.TIMEOUT)
    try:
        result = job(*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(job, *args, size: int = RANKS) -> list:
    """``job(*args)`` on ``size`` new processes joined in one gloo group on cuda:0; their results
    in rank order. A rank that raises or dies fails the run (the others are stopped)."""
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        torch.multiprocessing.start_processes(_rank_entry, args=(size, root, job, args),
                                              nprocs=size, join=True, start_method="spawn")
        out = []
        for rank in range(size):
            with open(os.path.join(root, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def _group_line() -> str:
    rank, size = mesh.world()
    return (f"rank {rank} of {size}, backend {dist.get_backend()}, device "
            f"cuda:{torch.cuda.current_device()}")


def _decisions_agree(one: dict, two: dict, gap: float) -> int:
    """Raise unless every comparison whose margin |s_ab - s_ac| on one rank exceeds twice the
    largest score gap is decided the same on two ranks; the number of such comparisons."""
    held = 0
    for i, (ab, ac) in one.items():
        if abs(ab - ac) > 2 * gap:
            held += 1
            if (ab > ac) != (two[i][0] > two[i][1]):
                raise SystemExit(f"comparison {i} decided differently on {RANKS} ranks")
    return held


def torchrun_worker(argv: list) -> int:
    """``chip_smoke.py --torchrun-cli ARGS`` under torchrun: the CLI's ``main`` (what ``python
    -m diffsim_tpu_torch.cli.main cute ARGS`` runs) with the launch counts set to 0 before it,
    then one line with the counts, the backend and the world."""
    from diffsim_tpu_torch.cli import main as cli_main

    kernels.reset_launch_counts()
    sys.argv = ["diffsim_tpu_torch.cli.main", "cute", *argv]
    cli_main.main()
    torch.cuda.synchronize()
    print("TORCHRUN " + json.dumps({"counts": kernels.launch_counts(), "group": _group_line()}),
          flush=True)
    dist.destroy_process_group()
    return 0


def _run_group(cmd: list, timeout: float) -> subprocess.CompletedProcess:
    """``cmd`` in a session of its own; at the timeout its whole process group is stopped."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGTERM)
        try:
            proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
        raise SystemExit(f"{cmd[:6]} did not end within {timeout:.0f} s")
    return subprocess.CompletedProcess(cmd, proc.returncode, out, None)


def torchrun_cli_phase(tree: str, cli: dict) -> dict:
    phase("torchrun --standalone --nproc_per_node 1: the 2AFC CLI's main at full SD-1.5 width "
          "under torchrun (NCCL, world size 1), cute --preset cute through the moment cache; its "
          f"results against the one-process run's (|d score| <= {RANKS_TOL:g}), 32 K1 and 16 K2")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "torchrun.jsonl")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", os.path.abspath(__file__), "--torchrun-cli",
               "--preset", "cute", "--image_path", tree, "--batch_size", str(CLI_BATCH),
               "--results", out]
        t0 = time.perf_counter()
        res = _run_group(cmd, 600)
        wall = time.perf_counter() - t0
        tail = res.stdout.strip().splitlines()[-12:]
        if res.returncode != 0:
            raise SystemExit("torchrun failed (rc %d):\n%s" % (res.returncode, "\n".join(tail)))
        info = json.loads(next(line for line in res.stdout.splitlines()
                               if line.startswith("TORCHRUN "))[len("TORCHRUN "):])
        with open(out) as f:
            scores = {r["idx"]: (r["s_ab"], r["s_ac"]) for r in map(json.loads, f)}
    gap = _scores_gap(cli["scores"], scores)
    want = {**NONE, "fused_self_attention": 8 * cli["forwards"],
            "fused_geglu_ff": 4 * cli["forwards"]}
    print(f"  torchrun: {info['group']}; {len(scores)} comparisons in {wall:.1f} s with the "
          f"launcher, the process and the scorer's init; launches {info['counts']}; max |d "
          f"score| against one process {gap:.3e}", flush=True)
    if sorted(scores) != list(range(60)) or gap > RANKS_TOL or info["counts"] != want:
        raise SystemExit(f"torchrun: the CLI disagrees with the one-process run (expected "
                         f"launches {want})")
    if "backend nccl" not in info["group"] or "rank 0 of 1" not in info["group"]:
        raise SystemExit(f"torchrun: not an NCCL group of one: {info['group']}")
    return {"wall_s": wall, "max_gap": gap, "counts": info["counts"]}


def _blocks(n: int) -> list:
    """The rows each rank should score of a call of ``n`` rows: contiguous blocks of ceil(n /
    RANKS), written out here rather than taken from ``mesh.shard_rows``."""
    block = -(-n // RANKS)
    return [range(min(r * block, n), min((r + 1) * block, n)) for r in range(RANKS)]


def _replay_gaps(full: np.ndarray, blocks: list) -> tuple[float, float | None]:
    """max |d| of a gathered call's scores ``full`` against each rank's block scored again
    (``blocks``, in rank order), and against the blocks swapped between ranks 0 and 1 where
    both are as long (None where no two are): the check and its control."""
    local = np.concatenate(blocks)
    gap = float(np.abs(full - local).max()) if len(full) else 0.0
    if len(blocks[0]) != len(blocks[1]) or not len(blocks[0]):
        return gap, None
    swapped = np.concatenate([blocks[1], blocks[0], *blocks[2:]])
    return gap, float(np.abs(full - swapped).max())


def _cli_job(tree: str, argv: list) -> dict:
    """The ``cute`` CLI on this rank; then this rank's block of every call scored again by the
    unsharded call, through the moment cache the run left warm (scores bit for bit as the run's,
    the CLI phase's all-hit rescore)."""
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report, (adapter,) = run_benchmark("cute", argv, device="cuda:0")
    torch.cuda.synchronize()
    out = {"group": _group_line(), "wall": time.perf_counter() - t0,
           "report": (report.total, report.correct, report.correct_2x),
           "counts": kernels.launch_counts(), "rows": adapter.score_triplet_paths.rows,
           "stats": dict(adapter.scorer._moment_cache.stats)}
    local = adapter.score_triplet_paths.__wrapped__  # registry.over_ranks keeps the call it wraps
    plan = benchmarks.cute(tree, 2334)
    replay = {}
    for i in range(0, len(plan), CLI_BATCH):
        rows = _blocks(len(plan[i:i + CLI_BATCH]))[dist.get_rank()]
        mine = [plan[i + j] for j in rows]
        if mine:
            s_ab, s_ac = local(*([getattr(c, r) for c in mine] for r in "abc"),
                               prompts=[c.prompt for c in mine])
            replay.update({i + j: (float(x), float(y)) for j, x, y in zip(rows, s_ab, s_ac)})
    out["replay"] = replay
    return out


def ranks_cli_phase(tree: str, cli: dict) -> dict:
    phase(f"the 2AFC CLI on {RANKS} ranks on cuda:0 over gloo at full SD-1.5 width: cute "
          "--preset cute through the moment cache, each call's triplets sharded; rank 0's "
          f"results against the one-process run's (|d score| <= {RANKS_TOL:g}, the same "
          "decisions beyond twice the gap) and against each rank's blocks scored again "
          f"unsharded at their own shape (|d score| <= {RANKS_REPLAY_TOL:g}, and the blocks "
          "swapped must exceed it), 30 comparisons a rank")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ranks.jsonl")
        argv = ["--preset", "cute", "--image_path", tree, "--batch_size", str(CLI_BATCH),
                "--results", out]
        t0 = time.perf_counter()
        ranks = run_ranks(_cli_job, tree, argv)
        wall = time.perf_counter() - t0
        with open(out) as f:
            lines = f.read().splitlines()
    scores = {r["idx"]: (r["s_ab"], r["s_ac"]) for r in map(json.loads, lines)}
    gap = _scores_gap(cli["scores"], scores)
    held = _decisions_agree(cli["scores"], scores, gap)
    replay = {i: v for r in ranks for i, v in r["replay"].items()}
    replay_gap, control = 0.0, 0.0
    for i in range(0, 60, CLI_BATCH):
        idx = [[i + j for j in rows] for rows in _blocks(len(range(i, min(i + CLI_BATCH, 60))))]
        for side in (0, 1):
            g, c = _replay_gaps(np.array([scores[k][side] for b in idx for k in b]),
                                [np.array([replay[k][side] for k in b]) for b in idx])
            replay_gap, control = max(replay_gap, g), max(control, c or 0.0)
    for r in ranks:
        # each call's rows are split in blocks of ceil(n / 2): every rank runs one forward a call
        blocks = [-(-min(CLI_BATCH, 60 - i) // RANKS) for i in range(0, 60, CLI_BATCH)]
        forwards = sum(-(-b // cli["step"]) for b in blocks)
        want = {**NONE, "fused_self_attention": 8 * forwards, "fused_geglu_ff": 4 * forwards}
        print(f"  {r['group']}: {r['rows']} comparisons scored, launches {r['counts']} "
              f"(expected {want}), moment cache {r['stats']}, report {r['report']}, "
              f"{r['wall']:.1f} s with the scorer's init", flush=True)
        if r["rows"] != 60 // RANKS or r["counts"] != want:
            raise SystemExit("the CLI on two ranks: a rank scored or launched other than "
                             "expected")
    print(f"  rank 0's file: {len(lines)} lines; max |d score| against one process {gap:.3e} "
          f"(limit {RANKS_TOL:g}); {held} of 60 comparisons decided beyond twice the gap, all "
          f"the same; against the ranks' blocks scored again {replay_gap:.3e} (limit "
          f"{RANKS_REPLAY_TOL:g}; the blocks swapped: {control:.3e}); {wall:.1f} s with the "
          "processes' start", flush=True)
    if len(lines) != 60 or sorted(scores) != list(range(60)) or gap > RANKS_TOL:
        raise SystemExit("the CLI on two ranks disagrees with one process")
    if sorted(replay) != list(range(60)) or replay_gap > RANKS_REPLAY_TOL:
        raise SystemExit("the CLI on two ranks: rank 0's file disagrees with the ranks' blocks")
    if control <= RANKS_REPLAY_TOL:
        raise SystemExit("the CLI on two ranks: the blocks' scores are too close to tell a swap")
    if ranks[0]["report"] != ranks[1]["report"]:
        raise SystemExit("the ranks report different accuracies")
    return {"wall_s": wall, "max_gap": gap, "decided": held, "replay_gap": replay_gap,
            "replay_control": control, "launches": [r["counts"] for r in ranks], "rows": [r["rows"] for r in ranks]}


def _serve_job(flags: list, requests: list) -> dict:
    import threading

    kernels.reset_launch_counts()
    args = arg_parse(flags)
    if dist.get_rank() != 0:
        adapter = serve.follow(args, device="cuda:0")
        return {"group": _group_line(), "rows": adapter.score_pairs.rows,
                "counts": kernels.launch_counts()}
    server, batcher = serve.make_server(args, 0, max_wait_ms=200.0, device="cuda:0")
    sharded, rounds = batcher._score, []

    def recorded(pix_a, pix_b, prompts):  # each round's inputs and gathered scores, kept
        scores = sharded(pix_a, pix_b, prompts)
        rounds.append((pix_a, pix_b, prompts, np.asarray(scores)))
        return scores

    batcher._score = recorded
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    results, latency = [None] * len(requests), [None] * len(requests)

    def client(i):
        t0 = time.perf_counter()
        results[i] = _post(port, {"pairs": requests[i], "prompt": CUTE["prompt"]})["scores"]
        latency[i] = (time.perf_counter() - t0) * 1e3

    try:
        # a warm-up round of two pairs, one a rank, then the burst
        _post(port, {"pairs": requests[2], "prompt": CUTE["prompt"]})
        clients = [threading.Thread(target=client, args=(i,)) for i in range(len(requests))]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=600)
        rows = sharded.rows
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        batcher.close()
    counts = kernels.launch_counts()
    # every round's blocks scored again here by the unsharded call, at the shape each rank had
    local, replay = sharded.__wrapped__, []
    for pix_a, pix_b, prompts, scores in rounds:
        blocks = [np.asarray(local(pix_a[b.start:b.stop], pix_b[b.start:b.stop],
                                   prompts[b.start:b.stop]), np.float32) if len(b) else
                  np.zeros(0, np.float32) for b in _blocks(len(prompts))]
        replay.append((len(prompts), *_replay_gaps(scores, blocks)))
    return {"group": _group_line(), "rows": rows, "counts": counts, "results": results,
            "latency_ms": latency, "replay": replay}


def ranks_serve_phase(served: dict) -> dict:
    phase(f"the scoring service on {RANKS} ranks on cuda:0 over gloo at full SD-1.5 width: rank 0 "
          "serves (make_server, max_wait_ms 200), rank 1 follows its rounds; a warm-up round of "
          "two pairs, then one burst of 3 concurrent requests (4 pairs); the scores within "
          f"{RANKS_TOL:g} of the one-process service's, and every round's within "
          f"{RANKS_REPLAY_TOL:g} of its blocks scored again unsharded on the leader (the blocks "
          "swapped must exceed it), both ranks scoring rows")
    p = served["paths"]
    requests = [[[p[0], p[1]]], [[p[2], p[3]]], [[p[4], p[5]], [p[1], p[4]]]]
    flags = SERVE_FLAGS + ["--batch_size", str(SERVE_BATCH)]
    t0 = time.perf_counter()
    leader, follower = run_ranks(_serve_job, flags, requests)
    wall = time.perf_counter() - t0
    gap = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
              for a, b in zip(leader["results"], served["burst_scores"]))
    for r in (leader, follower):
        k1, k2 = r["counts"]["fused_self_attention"], r["counts"]["fused_geglu_ff"]
        print(f"  {r['group']}: {r['rows']} pairs scored, launches {r['counts']}", flush=True)
        if r["rows"] < 1 or k1 < 8 or r["counts"] != {**NONE, "fused_self_attention": k1,
                                                      "fused_geglu_ff": k1 // 2} or k1 % 8:
            raise SystemExit("the service on two ranks: a rank scored no rows or launched "
                             "other than 8 K1 and 4 K2 a forward")
    replay_gap = max(g for _, g, _ in leader["replay"])
    control = max((c for _, _, c in leader["replay"] if c is not None), default=0.0)
    print(f"  served: the burst's request latency {[f'{x:.1f}' for x in leader['latency_ms']]} "
          f"ms (information); max |d score| against the one-process service {gap:.3e} (limit "
          f"{RANKS_TOL:g}); rounds of {[n for n, _, _ in leader['replay']]} pairs, against "
          f"their blocks scored again {replay_gap:.3e} (limit {RANKS_REPLAY_TOL:g}; the blocks "
          f"swapped: {control:.3e}); {wall:.1f} s with the processes' start", flush=True)
    if leader["rows"] + follower["rows"] != 2 + 4 or gap > RANKS_TOL:
        raise SystemExit("the service on two ranks disagrees with one process")
    if sum(n for n, _, _ in leader["replay"]) != 2 + 4 or replay_gap > RANKS_REPLAY_TOL:
        raise SystemExit("the service on two ranks: a round disagrees with its ranks' blocks")
    if control <= RANKS_REPLAY_TOL:
        raise SystemExit("the service on two ranks: the blocks' scores are too close to tell a "
                         "swap")
    for scores in leader["results"]:
        _check_scores("serve on two ranks", np.asarray(scores))
    return {"wall_s": wall, "max_gap": gap, "replay_gap": replay_gap, "replay_control": control,
            "rows": [leader["rows"], follower["rows"]],
            "latency_ms": leader["latency_ms"],
            "launches": [leader["counts"], follower["counts"]]}


def _train_job(argvs: dict) -> dict:
    """Each ``dit_train.main`` run of ``argvs`` in turn, in this rank's one process."""
    out = {}
    for mode, argv in argvs.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with _watched(DiTTrainer, "train_step") as steps, _grad_sums() as sums:
            trainer = dit_train.main(argv, device="cuda:0")
        out[mode] = {"group": _group_line(), "wall": time.perf_counter() - t0,
                     "step": trainer.step, "losses": [s["out"]["loss"] for s in steps],
                     "step_ms": [s["ms"] for s in steps], "counts": [s["counts"] for s in steps],
                     "sum_ms": sums["ms"], "grads_own": sums["own"],
                     "grads_summed": sums["summed"],
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del trainer
    return out


def _load_state(ckpt_dir: str, mmap: bool = False) -> dict:
    return torch.load(os.path.join(ckpt_dir, "trainer_state.pt"), map_location="cpu",
                      weights_only=True, mmap=mmap)


def _mean_gap(a: dict, b: dict) -> float:
    """The mean |a - b| over every entry of two state dicts' tensors."""
    total = sum(float((a[k].double() - v.double()).abs().sum()) for k, v in b.items())
    return total / sum(v.numel() for v in b.values())


def ranks_train_phase(tmp: str, train: dict) -> dict:
    phase(f"dit_train --distributed on {RANKS} ranks on cuda:0 over gloo: DiT-XL/2 at 256 px, "
          f"global batch {TRAIN_BATCH} ({TRAIN_BATCH // RANKS} a rank), float32 for 3 steps "
          "(checkpoint at step 2) and --bf16 for 1; the per-step losses against the one-process "
          f"runs' (relative {RANKS_LOSS_RTOL}), the first step's summed gradients against one "
          f"process's (max |d| / the leaf's largest entry {RANKS_GRAD_TOL:g}; each rank's own "
          "gradient must exceed it), rank 0's checkpoint against the one-process one (mean |d| "
          f"{RANKS_CKPT_MEAN_TOL}; the one-process checkpoint two steps later must exceed it); "
          "the gradient sum timed in every step")
    base = train["base"] + ["--vae_weights", train["vae_npz"], "--distributed"]
    one_ckpt = _load_state(train["ckpt2"])  # held on the host: 2 checkpoints on disk at most
    shutil.rmtree(train["ckpt2"])
    runs = {"float32": (["--ckpt_every", "2"], 3), "bf16": (["--ckpt_every", "1000", "--bf16"], 1)}
    t0 = time.perf_counter()
    every = run_ranks(_train_job, {
        mode: base + ["--results_dir", os.path.join(tmp, f"ranks_{mode}"), "--max_steps",
                      str(steps), *extra] for mode, (extra, steps) in runs.items()})
    wall = time.perf_counter() - t0
    print(f"  both runs on {RANKS} ranks: {wall:.1f} s with the processes' start", flush=True)
    out = {"wall_s": wall}
    for mode, (_, steps) in runs.items():
        results = os.path.join(tmp, f"ranks_{mode}")
        ranks = [r[mode] for r in every]
        one = train["runs"][mode]["losses"][:steps]
        gaps = [abs(a / b - 1) for a, b in zip(ranks[0]["losses"], one)]
        for r in ranks:
            print(f"  {mode}, {r['group']}: losses {r['losses']}, step ms "
                  f"{[round(x, 1) for x in r['step_ms']]}, of which the gradient sum "
                  f"{[round(x, 1) for x in r['sum_ms']]}, launches a step {r['counts']}, "
                  f"peak {r['peak_gib']:.2f} GiB", flush=True)
            if r["losses"] != ranks[0]["losses"] or r["step"] != steps:
                raise SystemExit(f"dit_train --distributed {mode}: the ranks disagree")
            if any(c != TRAIN_STEP for c in r["counts"]):
                raise SystemExit(f"dit_train --distributed {mode}: launches a step {r['counts']}"
                                 f", expected {TRAIN_STEP}")
        print(f"  {mode}: one process's losses {one}; relative gaps {gaps} (limit "
              f"{RANKS_LOSS_RTOL[mode]:g}); the run {ranks[0]['wall']:.1f} s with the trainer's "
              "init", flush=True)
        if max(gaps) > RANKS_LOSS_RTOL[mode]:
            raise SystemExit(f"dit_train --distributed {mode}: the losses disagree with one "
                             "process")
        out[mode] = {"losses": ranks[0]["losses"], "loss_gaps": gaps, "wall_s": ranks[0]["wall"],
                     "step_ms": [r["step_ms"] for r in ranks],
                     "sum_ms": [r["sum_ms"] for r in ranks],
                     "peak_gib": [r["peak_gib"] for r in ranks]}
        if mode == "float32":
            want = train["runs"][mode].pop("grads")
            grad_gap = max(_grad_gap(r["grads_summed"], want) for r in ranks)
            grad_control = min(_grad_gap(r["grads_own"], want) for r in ranks)
            print(f"  {mode}: the first step's summed gradients against one process's within "
                  f"{grad_gap:.3e} of each leaf's largest entry (limit {RANKS_GRAD_TOL:g}; a "
                  f"rank's own gradient, before the sum: {grad_control:.3e}), "
                  f"{len(want)} leaves, {GRAD_SAMPLE} entries each at most", flush=True)
            if grad_gap > RANKS_GRAD_TOL or grad_control <= RANKS_GRAD_TOL:
                raise SystemExit("dit_train --distributed: the summed gradients disagree with "
                                 "one process's, or the check cannot tell a missing sum")
            out[mode].update(grad_gap=grad_gap, grad_control=grad_control)
            files = sorted(os.listdir(results))
            if files != ["ckpt_0000002", "log.txt"]:
                raise SystemExit(f"dit_train --distributed wrote {files}")
            t0 = time.perf_counter()
            two = _load_state(os.path.join(results, "ckpt_0000002"), mmap=True)
            later = _load_state(train["ckpt"], mmap=True)  # the one-process run's step 4
            gaps = {key: _mean_gap(two[key], one_ckpt[key]) for key in ("params", "ema")}
            controls = {key: _mean_gap(later[key], one_ckpt[key]) for key in ("params", "ema")}
            top = max((two["params"][k] - v).abs().max().item()
                      for k, v in one_ckpt["params"].items())
            print(f"  rank 0's checkpoint at step {two['step']}: mean |d| weights "
                  f"{gaps['params']:.3e}, EMA {gaps['ema']:.3e} against the one-process "
                  f"checkpoint (limits {RANKS_CKPT_MEAN_TOL}; the one-process step 4 against its "
                  f"step 2: {controls['params']:.3e}, {controls['ema']:.3e}); max |d| weights "
                  f"{top:.3e} (information); compared in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            if two["step"] != 2 or any(gaps[k] > RANKS_CKPT_MEAN_TOL[k]
                                       or controls[k] <= RANKS_CKPT_MEAN_TOL[k] for k in gaps):
                raise SystemExit("dit_train --distributed: the checkpoint disagrees with one "
                                 "process's, or the check cannot tell a checkpoint two steps off")
            out[mode].update(ckpt_mean_gaps=gaps, ckpt_controls=controls, ckpt_max_gap=top)
            del two, one_ckpt, later
        shutil.rmtree(results)
    return out


def _sample_job(argv: list) -> dict:
    kernels.reset_launch_counts()
    with _watched(DiTTrainer, "sample") as calls:
        dit_sample.main(argv, device="cuda:0")
    return {"group": _group_line(), "images": calls[0]["out"], "ms": calls[0]["ms"],
            "counts": calls[0]["counts"]}


def ranks_sample_phase(tmp: str, train: dict, sampled: dict) -> dict:
    phase(f"dit_sample on {RANKS} ranks on cuda:0 over gloo: DiT-XL/2 at 256 px from the "
          f"training checkpoint, --ddim, CFG 4.0, {SAMPLE_STEPS} steps, the 8 default labels "
          f"4 a rank; the decoded images against the one-process run's (within "
          f"{RANKS_IMAGE_ATOL:g} in [-1, 1])")
    target = os.path.join(tmp, "grid_ddim_ranks.png")
    argv = ["--ckpt", train["ckpt"], "--vae_weights", train["vae_npz"], "--model", "DiT-XL/2",
            "--image_size", str(TRAIN_SIZE), "--cfg_scale", "4.0", "--num_sampling_steps",
            str(SAMPLE_STEPS), "--ddim", "--out", target]
    t0 = time.perf_counter()
    ranks = run_ranks(_sample_job, argv)
    wall = time.perf_counter() - t0
    one = sampled["ddim"]["images"]
    gap = float(np.abs(ranks[0]["images"] - one).max())
    for r in ranks:
        want = {**NONE, "fused_self_attention": 28 * SAMPLE_STEPS}
        print(f"  {r['group']}: the sample call {r['ms']:.0f} ms, launches {r['counts']}",
              flush=True)
        if r["counts"] != want or not np.array_equal(r["images"], ranks[0]["images"]):
            raise SystemExit(f"dit_sample on two ranks: launches {r['counts']} (expected "
                             f"{want}) or the ranks' images differ")
    print(f"  max |d image| against one process {gap:.3e} (limit {RANKS_IMAGE_ATOL:g}); the grid "
          f"written once ({os.path.exists(target)}); {wall:.1f} s with the processes' start",
          flush=True)
    if ranks[0]["images"].shape != one.shape or gap > RANKS_IMAGE_ATOL or not os.path.exists(
            target):
        raise SystemExit("dit_sample on two ranks disagrees with one process")
    return {"wall_s": wall, "max_gap": gap, "sample_ms": [r["ms"] for r in ranks]}


def profile_call(fn, what: str, top: int = 14) -> None:
    """Device time by kernel over one call, from torch.profiler (information for PERF.md):
    the device's busy time is the sum of kernel self times (one stream, no overlap)."""
    if TIMING["method"] != "cupti":
        print(f"  profile of one {what}: not measured (device times by {TIMING['method']})")
        return
    kern, wall_ms = _kernel_records(fn, 1)
    kern.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in kern)
    if not kern:
        print("  profile: the profiler recorded no device time (not measured)")
        return
    print(f"  profile of one {what}: wall {wall_ms:.1f} ms under the profiler, device "
          f"busy {busy:.1f} ms ({100 * busy / wall_ms:.1f} %) in {sum(r[1] for r in kern)} "
          "kernel launches; top kernels by device time:")
    for name, count, ms in kern[:top]:
        print(f"    {ms:8.2f} ms {100 * ms / busy:5.1f} % x{count:<4d} {name[:100]}")


def _totals(rows, key) -> dict | None:
    """A kernel's numbers summed over one call's launches: ``key`` names each timed row's
    launches per call."""
    rows = [r for r in rows if r.get(key) and "ms" in r]
    if not rows:
        return None

    def total(field):
        if any(r.get(field) is None for r in rows):
            return None
        return sum(r[field] * r[key] for r in rows)

    ms, bound_ms = total("ms"), total("bound_ms")
    ops_ms = sum(r["bound_ms"] * r[key] for r in rows if r["bound_by"] == "operations")
    out = {"ms": ms, "plain_ms": total("plain_ms"), "bound_ms": bound_ms,
           "bound_by": "operations" if ops_ms >= bound_ms / 2 else "bytes",
           "library_ms": total("library_ms"), "roofline_share": bound_ms / ms,
           "peak": rows[0]["peak"], "timing": "+".join(sorted({r["timing"] for r in rows}))}
    for field in ("v2_ms", "cublas_path_ms", "epilogue_ms", "call_ms", "exact_ms", "sdpa_exact_ms"):
        if total(field) is not None:
            out[field] = total(field)
    return out


SD15_PER = "one SD-1.5 UNet forward at B=24 (sum over its launches)"
K1_DESIGN = "wgmma+TMA, persistent, 3 ping-ponged consumer warpgroups (bf16)"
K2_DESIGN = ("two persistent wgmma+TMA GEMMs, 2 ping-ponged consumer warpgroups on whole "
             "128-row tiles, GEGLU epilogue under the other's products (bf16)")
K3_DESIGN = ("K1's wgmma+TMA pipeline, cross then self pass per 128-row q block, "
             "2 ping-ponged consumer warpgroups (bf16)")
K4_DESIGN = "3xTF32 mma.sync (float32)"
K4_BF16_DESIGN = ("wgmma+TMA, 64-row q blocks, 2 consumer warpgroups splitting the keys of Q K^T "
                  "and the 512 output columns, K/V chunks through a 16 KB-slot mbarrier ring, "
                  "P V from shared memory under the next softmax (bf16)")
K4_WIDE_DESIGN = ("3xTF32 mma.sync, a 2-block cluster a q block, each block Q K^T and P V over "
                  "its share of D with Q's share resident, the partial scores exchanged through "
                  "distributed shared memory (float32)")
K4_WIDE_BF16_DESIGN = ("wgmma+TMA, K4 bf16's warp roles, a 2-block cluster a q block, each block "
                       "Q K^T and P V over its share of D, the partial scores exchanged through "
                       "distributed shared memory under the previous tile's P V (bf16)")
XL_BF16_PER = (f"one SDXL score_triplet_batch call with --xl_vae_bf16 ({XL_T} triplets, 1024 px), "
               "the sum over its launches")
K2_F32_DESIGN = ("two 3xTF32 mma.sync GEMMs, 8 warps a 128-row tile, 32-column k panels through "
                 "a 4-stage cp.async ring, a fresh tensor-core sum a panel (float32)")
K3_F32_DESIGN = ("K1's 3xTF32 mma.sync pass (attention_tf32.cuh) run twice a 64-row q tile, cross "
                 "then self, O1 kept in registers up to D = 80, partials in a fixed order "
                 "(float32)")
K1_F32_DESIGN = ("3xTF32 mma.sync, 4 warps of 16 q rows, scores and probabilities in registers, "
                 "K/V double-buffered by cp.async (float32)")
XL_PER = f"one SDXL score_triplet_batch call ({XL_T} triplets, 1024 px), the sum over its launches"
DIT_PER = (f"one DiT-XL/2 score_triplet_batch call ({DIT_T} triplets, 512 px, tap block 13), the "
           "sum over its launches")


def _path(result, launches, key, per) -> dict:
    return {"launches": launches, **_totals(result["rows"], key), "per": per}


def kernel_entry(name, source, replaces, design, result, path, sdxl=None, dit=None,
                 sd15=None) -> dict:
    """One kernel's entry of the kernels line. ``path`` = (launches, row key, per) gives the
    top-level numbers, summed over one call of the path the kernel was ported on: one SD-1.5
    UNet forward for K1 and K2 (as the first slice reported them), one SDXL triplet call for
    K3 and K4. ``sdxl`` gives K1's and K2's numbers over one SDXL triplet call, under "sdxl";
    ``dit`` K1's and K3's over one DiT-XL/2 triplet call, under "dit"; ``sd15`` another SD-1.5
    call's, under "sd15"."""
    entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "design": design, "max_abs_err": result["max_abs_err"], **_path(result, *path)}
    for key, sub in (("sdxl", sdxl), ("dit", dit), ("sd15", sd15)):
        if sub is not None:
            entry[key] = _path(result, *sub)
    entry["shapes"] = result["rows"]
    return entry


TRAIN_PER = f"one DiT-XL/2 training step at batch {TRAIN_BATCH}, 256 px (the forward's launches)"
TRAIN_BWD_PER = (f"one DiT-XL/2 training step at batch {TRAIN_BATCH}, 256 px (the backward's "
                 "launches)")
K1_BWD_DESIGN = ("two kernels, seven products, no atomics: a statistics pass on K1's forward "
                 "pipeline (L, Delta = g . O), then a block a head over its key blocks in order "
                 "(S^T, dp^T, dV, dK, dQ's share summed in key block order); bf16 wgmma + TMA, 2 "
                 "consumer warpgroups of 64 keys and a producer warp, W and dS in bf16; float32 "
                 "3xTF32 mma.sync, 4 warps of 16 keys")


SAMPLE_PER = "one DiT-XL/2 denoising step with CFG on 8 labels, 256 px, float32"


def train_entries(k1_grad: dict, runs: dict, sampled: dict) -> list[dict]:
    """K1's rows on the training path, float32 (the trainer's default) and bf16 (``--bf16``),
    each the forward's entry and then the backward kernel's: the time per step at the training
    site beside its bound, its plain version's and SDPA's (forward or backward), with the
    launches per step of the CLI runs in that dtype. The forward's ``max_abs_err`` is its error
    against the plain version and ``grad_max_abs_err`` the gradients' (through autograd and the
    backward kernel's own); the backward's ``max_abs_err`` is its gradients' against
    ``fused_self_attention_bwd_plain``, over every shape it was checked at. The forward names the
    backward under "backward". The float32 forward carries the sampler's numbers per denoising
    step under "sample"."""
    entries = []
    for dtype, key, mode in ((torch.float32, "launches_dit_train_step", "float32"),
                             (torch.bfloat16, "launches_dit_train_step_bf16", "bf16")):
        name = str(dtype)[6:]
        run = runs[mode]
        per_step = run["counts"]["fused_self_attention"] // run["steps"]
        bwd_per_step = run["counts"]["fused_self_attention_bwd"] // run["steps"]
        result = {"rows": [r for r in k1_grad["rows"] if r["dtype"] == name],
                  "max_abs_err": k1_grad["err"][dtype]}
        entry = kernel_entry(f"fused_self_attention (DiT train, {name})",
                             "diffsim_tpu_torch/csrc/fused_attention.cu",
                             "diffsim_tpu/ops/pallas/attention.py:101",
                             K1_DESIGN if dtype == torch.bfloat16 else K1_F32_DESIGN, result,
                             (per_step, key, TRAIN_PER))
        bwd = kernel_entry(f"fused_self_attention_bwd (DiT train, {name})",
                           "diffsim_tpu_torch/csrc/fused_attention_bwd.cu",
                           "diffsim_tpu/ops/pallas/attention.py:132", K1_BWD_DESIGN,
                           {"rows": [r for r in k1_grad["bwd_rows"] if r["dtype"] == name],
                            "max_abs_err": k1_grad["bwd_err"][dtype]},
                           (bwd_per_step, key, TRAIN_BWD_PER))
        in_dtype = {m: r for m, r in runs.items() if (m == "bf16") == (dtype == torch.bfloat16)}
        bwd["launches_run"] = {m: r["counts"]["fused_self_attention_bwd"]
                               for m, r in in_dtype.items()}
        entry["backward"] = {"kernel": bwd["name"], "source": bwd["source"],
                             "replaces": "_fused_bwd, diffsim_tpu/ops/pallas/attention.py:132",
                             **{f: bwd[f] for f in ("launches", "ms", "plain_ms", "library_ms",
                                                    "bound_ms", "bound_by")},
                             "grad_max_abs_err": k1_grad["bwd_err"][dtype]}
        for field, of in (("bwd_ms", "ms"), ("bwd_plain_ms", "plain_ms"),
                          ("bwd_sdpa_ms", "library_ms"), ("bwd_bound_ms", "bound_ms")):
            entry[field] = bwd[of]
        entry["grad_max_abs_err"] = k1_grad["grad_err"][dtype]
        entry["launches_run"] = {m: r["counts"]["fused_self_attention"]
                                 for m, r in in_dtype.items()}
        if dtype == torch.float32:
            run = sampled["ancestral"]
            per_step = run["counts"]["fused_self_attention"] // (SAMPLE_STEPS * run["calls"])
            entry["sample"] = _path(result, per_step, "launches_dit_sample_step", SAMPLE_PER)
            entry["launches_run"].update({f"sample_{m}": r["counts"]["fused_self_attention"]
                                          for m, r in sampled.items()})
        entries += [entry, bwd]
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--torchrun-cli"]:  # the worker of torchrun_cli_phase
        return torchrun_worker(sys.argv[2:])
    phase("card")
    card_line = card()
    phase("build")
    t0 = time.perf_counter()
    reports = build.build(build.SOURCES + build.BASELINES)
    PTXAS.update(reports)
    print(f"  built {sorted(reports) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "warning" in line or "built in" in line:
                print(f"  {name}: {line.strip()}")
    probe_timing()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    k1 = k1_phase(gen)
    k2 = k2_phase(gen)
    k3 = k3_phase(gen)
    k4 = k4_phase(gen)
    k1_fast = k1_fast_phase(gen)
    k4_fast = k4_fast_phase(gen)
    k4_wide = k4_wide_phase(gen)
    k1_grad = k1_grad_phase(gen)
    domain = kernel_domain_phase(gen)
    tiny_phase()
    tiny_xl_phase()
    tiny_dit_phase()
    tiny_surface_phase()
    tiny_baselines = tiny_baselines_phase()
    tiny_train_phase()
    sam_tiny_phase()
    sd15_out = sd15_phase(card_line)
    sd15 = sd15_out["counts"]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tree = _cute_tree(tmp)
        cli = cli_phase(card_line, tree)
        surface_cli = surface_cli_phase(tree)
        fast768 = sd15_fast_768_phase()
        xl_out = sdxl_phase(card_line)
        xl = xl_out["counts"]
        torch.cuda.empty_cache()
        xl_bf16 = sdxl_bf16_vae_phase(card_line, xl_out.pop("pix"), xl_out["vae_split"])
        dit_out = dit_phase(card_line)
        dit_counts = dit_out["counts"]
        torch.cuda.empty_cache()
        f32 = f32_scoring_phase(card_line, {"sd15": sd15_out["repeat_ms"],
                                            "sdxl": xl_out["repeat_ms"],
                                            "dit": dit_out["repeat_ms"]})
        dit_cli = dit_cli_phase(tree)
        baseline_npz = convert_baselines_phase(tmp)
        baselines = baselines_phase(card_line, registry._load_params(baseline_npz["u2net"]))
        baseline_cli = baseline_cli_phase(tree, baseline_npz["u2net"])
        sam_h = sam_vit_h_phase(card_line)
        sam_cli = sam_cli_phase(tree)
        served = serve_phase(tree, card_line)
        ranked = rank_phase(tree, card_line)
        torchrun_cli = torchrun_cli_phase(tree, cli)
        ranks_cli = ranks_cli_phase(tree, cli)
        ranks_served = ranks_serve_phase(served)
    converted = convert_phase()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        train = train_cli_phase(tmp, card_line)
        sampled = sample_cli_phase(tmp, train, card_line)
        ranks_train = ranks_train_phase(tmp, train)
        ranks_sampled = ranks_sample_phase(tmp, train, sampled)

    def on_sd15(kernel):
        return sd15[kernel], "launches_sd15_forward", SD15_PER

    def on_xl(kernel):
        return xl[kernel], "launches_sdxl_call", XL_PER

    def on_dit(kernel):
        return dit_counts[kernel], "launches_dit_call", DIT_PER

    fast_cli = cli["fast_counts"]["fused_self_attention"]
    if fast_cli != 8 * cli["forwards"]:
        raise SystemExit(f"the --bf16_softmax CLI run took K1's mode {fast_cli} times in "
                         f"{cli['forwards']} UNet forwards, not 8 per forward")
    fast_k1 = kernel_entry(
        "fused_self_attention (bf16_probs)", "diffsim_tpu_torch/csrc/fused_attention.cu",
        "diffsim_tpu/ops/pallas/attention.py:51", K1_DESIGN + ", bf16_probs instantiation",
        k1_fast, (fast_cli // cli["forwards"], "launches_sd15_forward", SD15_PER))
    fast_k1["launches_cli"] = fast_cli  # the whole --bf16_softmax CLI run
    fast_k4 = kernel_entry(
        "streaming_self_attention (bf16_probs)", "diffsim_tpu_torch/csrc/streaming_attention.cu",
        "diffsim_tpu/ops/pallas/attention_stream.py:62", K4_BF16_DESIGN + ", bf16_probs "
        "instantiation; float32: 3xTF32 Q K^T, 2 TF32 products for P V", k4_fast,
        (fast768["fast_counts"]["streaming_self_attention"], "launches_sd15_768_pair",
         "one SD-1.5 score_batch pair in fast mode at 768 px"))

    line = {"kernels": [
        kernel_entry("fused_self_attention", "diffsim_tpu_torch/csrc/fused_attention.cu",
                     "diffsim_tpu/ops/pallas/attention.py:101", K1_DESIGN, k1,
                     on_sd15("fused_self_attention"), on_xl("fused_self_attention"),
                     on_dit("fused_self_attention")),
        kernel_entry("fused_geglu_ff", "diffsim_tpu_torch/csrc/geglu_ff.cu",
                     "diffsim_tpu/ops/pallas/ff.py:75", K2_DESIGN, k2,
                     on_sd15("fused_geglu_ff"), on_xl("fused_geglu_ff")),
        kernel_entry("cross_self_partials", "diffsim_tpu_torch/csrc/fused_readout.cu",
                     "diffsim_tpu/ops/pallas/readout.py:71", K3_DESIGN, k3,
                     on_xl("cross_self_partials"), dit=on_dit("cross_self_partials")),
        kernel_entry("streaming_self_attention", "diffsim_tpu_torch/csrc/streaming_attention.cu",
                     "diffsim_tpu/ops/pallas/attention_stream.py:94", K4_DESIGN, k4,
                     on_xl("streaming_self_attention")),
        kernel_entry("streaming_self_attention (bf16)",
                     "diffsim_tpu_torch/csrc/streaming_attention.cu",
                     "diffsim_tpu/ops/pallas/attention_stream.py:94", K4_BF16_DESIGN,
                     {"rows": k4["rows"], "max_abs_err": k4["bf16_max_abs_err"]},
                     (xl_bf16["counts"]["streaming_self_attention"], "launches_sdxl_bf16_call",
                      XL_BF16_PER)),
        fast_k1,
        fast_k4,
        *k4_wide_entries(k4_wide),
        *train_entries(k1_grad, train["runs"], sampled),
        kernel_entry("fused_geglu_ff (float32)", "diffsim_tpu_torch/csrc/geglu_ff.cu",
                     "diffsim_tpu/ops/pallas/ff.py:75", K2_F32_DESIGN, k2["f32"],
                     (f32["sd15"]["counts"]["fused_geglu_ff"], "launches_sd15_f32_forward",
                      F32_PER["sd15"]),
                     sdxl=(f32["sdxl"]["counts"]["fused_geglu_ff"], "launches_sdxl_f32_call",
                           F32_PER["sdxl"])),
        kernel_entry("cross_self_partials (float32)",
                     "diffsim_tpu_torch/csrc/fused_readout_f32.cu",
                     "diffsim_tpu/ops/pallas/readout.py:71", K3_F32_DESIGN, k3["f32"],
                     (f32["dit"]["counts"]["cross_self_partials"], "launches_dit_f32_call",
                      F32_PER["dit"]),
                     sdxl=(f32["sdxl"]["counts"]["cross_self_partials"], "launches_sdxl_f32_call",
                           F32_PER["sdxl"]),
                     sd15=(f32["sd15_k3"]["counts"]["cross_self_partials"],
                           "launches_sd15_k3_f32_call", F32_PER["sd15_k3"])),
    ]}
    next(e for e in line["kernels"]
         if e["name"] == "streaming_self_attention (bf16)")["sharp_logits"] = k4["sharp"]
    for entry in line["kernels"][:2]:  # K1 and K2 on this slice's main path, the CLI run
        entry["launches_cli"] = cli["counts"][entry["name"]]
    # the IP-Adapter, mask, diffeats and tap_values paths: each call's launches
    paths = {"sd15_ip_pairs_call": sd15_out["ip"]["counts"], **sd15_out["surface"],
             "sdxl_ip_pairs_call": xl_out["ip"]["counts"],
             **{what: run["counts"] for what, run in surface_cli.items()},
             # the baselines' calls at full width and their CLI runs (asserted: none) and the
             # ensemble CLI run (its diffsim member's forwards)
             "baselines_full_width": NONE,
             **{f"cli_{what}": run["counts"] for what, run in baseline_cli.items()},
             # SAM ViT-H's masks (asserted: none), the CLI with SAM masks, a service round of
             # the concurrent burst and each rank call (both routes)
             "sam_vit_h_masks": NONE, "cli_sam_masks": sam_cli["counts"],
             "serve_round": served["launches_round"],
             "rank_cached_2_calls": ranked["launches_cached"],
             "rank_pairs_3_calls": ranked["launches_pairs"],
             # several ranks: the CLI under torchrun (one NCCL rank), and each of two ranks on the
             # one card over gloo: the CLI run and the service's burst
             "torchrun_cli": torchrun_cli["counts"],
             **{f"ranks_cli_rank{r}": c for r, c in enumerate(ranks_cli["launches"])},
             **{f"ranks_serve_rank{r}": c for r, c in enumerate(ranks_served["launches"])}}
    for entry in line["kernels"][:4]:
        entry["launches_paths"] = {path: counts[entry["name"]] for path, counts in paths.items()}
    k1_xl = line["kernels"][0]["sdxl"]
    k2_sd, k2_xl = line["kernels"][1], line["kernels"][1]["sdxl"]
    k3_xl = line["kernels"][2]
    k4_row = next(r for r in k4["rows"] if r.get("launches_sdxl_call"))
    k4_bf16 = {tuple(r["shape"]): r for r in k4["rows"] if r["dtype"] == "bfloat16" and "ms" in r}
    epilogue = (f"{k3_xl['epilogue_ms']:.3f} on the device" if "epilogue_ms" in k3_xl
                else "not measured apart")
    print(f"  kernel times on {card_line}, device times by {TIMING['method']}:\n"
          f"  K1 per SDXL triplet call {k1_xl['ms']:.3f} ms (v2 {k1_xl['v2_ms']:.3f}, SDPA "
          f"{k1_xl['library_ms']:.3f}); K2 per SD-1.5 forward {k2_sd['ms']:.3f} ms (v2 "
          f"{k2_sd['v2_ms']:.3f}, cuBLAS path {k2_sd['cublas_path_ms']:.3f}), per SDXL call "
          f"{k2_xl['ms']:.3f} (v2 {k2_xl['v2_ms']:.3f}, cuBLAS path "
          f"{k2_xl['cublas_path_ms']:.3f}); K3 per SDXL call {k3_xl['ms']:.3f} ms (v2 "
          f"{k3_xl['v2_ms']:.3f}; the wrapper's torch epilogue {epilogue}, the whole calls "
          f"{k3_xl['call_ms']:.3f} by CUDA events); K4 float32 per launch {k4_row['ms']:.3f} "
          f"ms (v2 {k4_row['v2_ms']:.3f}, SDPA {k4_row['library_ms']:.3f})", flush=True)
    for shape, row in k4_bf16.items():
        print(f"  K4 bf16 {shape} per launch {row['ms']:.3f} ms (v2 {row['v2_ms']:.3f}, SDPA "
              f"{row['library_ms']:.3f}, bound {row['bound_ms']:.3f}, "
              f"{100 * row['bound_ms'] / row['ms']:.1f} %)", flush=True)
    for entry in line["kernels"]:
        if entry["name"].startswith("streaming_self_attention (wide"):
            for row in entry["shapes"]:
                print(f"  {entry['name']} {tuple(row['shape'])} per launch {row['ms']:.3f} ms "
                      f"(previous design v1 {row['v2_ms']:.3f}, SDPA {row['library_ms']:.3f}, "
                      f"bound {row['bound_ms']:.3f}, {100 * row['bound_ms'] / row['ms']:.1f} %, "
                      f"plain {row['plain_ms']:.3f}; bf16_probs mode "
                      f"{row['bf16_probs_ms']:.3f})", flush=True)
            print(f"  {entry['name']}: {entry['launches']} launch(es) a widened VAE encode, "
                  f"{entry['vae_encode']['encode_ms']:.1f} ms, moments within "
                  f"{entry['vae_encode']['moments_gap']:.3e} of the plain K4's (control "
                  f"{entry['vae_encode']['control_moments_gap']:.3e})", flush=True)
    print(f"  SDXL --xl_vae_bf16 triplet call {xl_bf16['call_ms']:.1f} ms, VAE encode "
          f"{xl_bf16['vae_ms']:.1f} ms; against the plain K4's call, scores within "
          f"{xl_bf16['plain_k4_gap']:.3e} and moments {xl_bf16['plain_k4_moments_gap']:.3e} "
          f"(control {xl_bf16['control_gap']:.3e} and {xl_bf16['control_moments_gap']:.3e})",
          flush=True)
    print(f"  bf16_probs mode: K1 per SD-1.5 forward {fast_k1['ms']:.3f} ms (exact "
          f"{fast_k1['exact_ms']:.3f}); K4 at {K4_768} bf16 {fast_k4['ms']:.3f} ms (exact "
          f"{fast_k4['exact_ms']:.3f}). CLI: hit rate {cli['hit_rate']:.4f}, pairs/s "
          f"{cli['pairs_per_s']}, cached vs fresh {cli['cached_vs_fresh']:.3e}, fast vs exact "
          f"{cli['fast_vs_exact']:.3e}", flush=True)
    k1_dit, k3_dit = line["kernels"][0]["dit"], line["kernels"][2]["dit"]
    print(f"  DiT-XL/2 on {card_line}: K1 per triplet call {k1_dit['ms']:.3f} ms in "
          f"{k1_dit['launches']} launches (SDPA {k1_dit['library_ms']:.3f}, bound "
          f"{k1_dit['bound_ms']:.3f}, {100 * k1_dit['roofline_share']:.1f} %); K3 per call "
          f"{k3_dit['ms']:.3f} ms in {k3_dit['launches']} launches (bound "
          f"{k3_dit['bound_ms']:.3f}, {100 * k3_dit['roofline_share']:.1f} %); repeat call {dit_out['repeat_ms']:.1f} ms, "
          f"peak {dit_out['peak_gib']:.2f} GiB, cached vs fresh {dit_out['cached_gap']:.3e}; "
          f"CLI --metric dit hit rate {dit_cli['hit_rate']:.4f}, "
          f"{dit_cli['pairs_per_s']:.2f} pairs/s", flush=True)
    for entry in line["kernels"][-2:]:
        subs = "; ".join(f"per {k} call {entry[k]['ms']:.3f} ms (v1 {entry[k]['v2_ms']:.3f})"
                         for k in ("sdxl", "sd15") if k in entry)
        print(f"  {entry['name']} on {card_line}: {entry['ms']:.3f} ms in {entry['launches']} "
              f"launches, {entry['per']} (first, FMA design {entry['v2_ms']:.3f}, bound "
              f"{entry['bound_ms']:.3f}, {100 * entry['roofline_share']:.1f} %); {subs}",
              flush=True)
    for what, res in f32.items():
        print(f"  float32 {what} triplet call {res['repeat_ms']:.1f} ms (bf16 "
              f"{res['bf16_repeat_ms']:.1f}), peak {res['peak_gib']:.2f} GiB, / limit against "
              f"the plain K2 and K3 {res['plain_limit_share']:.3f} (control "
              f"{res['control_limit_share']:.3f})", flush=True)
    for entry in line["kernels"]:
        if "(DiT train," in entry["name"]:
            v2 = f"previous design {entry['v2_ms']:.3f}, " if "v2_ms" in entry else ""
            print(f"  {entry['name']} on {card_line}: {entry['ms']:.3f} ms per training step in "
                  f"{entry['launches']} launches ({v2}plain {entry['plain_ms']:.3f}, SDPA "
                  f"{entry['library_ms']:.3f}, bound {entry['bound_ms']:.3f}, "
                  f"{100 * entry['roofline_share']:.1f} %); launches in the runs "
                  f"{entry['launches_run']}", flush=True)
    guards = [sd15_out["guard"], xl_out["guard"], dit_out["guard"],
              *(f32[what]["guard"] for what in ("sd15", "sdxl", "dit"))]
    for guard in guards:
        if (guard["per_triplet"] < guard["slope"] or guard["encode_bytes"] < guard["encode_peak"]
                or any(guard["estimates"][t] < guard["peaks"][t] for t in guard["peaks"])):
            raise SystemExit(f"{guard['name']}: the device-memory guard's constants are below "
                             f"what the card measured: {guard}")
    line["hbm_guard"] = guards
    pair_guards = [out[key] for out in (sd15_out, xl_out, dit_out, *f32.values())
                   for key in ("pair_guard", "ip_pair_guard") if key in out]
    for guard in pair_guards:
        if (guard["per_pair"] < max(guard["slope"], guard["tail_slope"])
                or any(guard["estimates"][p] < guard["peaks"][p] for p in guard["peaks"])):
            raise SystemExit(f"{guard['name']}: the device-memory guard's pair estimate is below "
                             f"what the card measured: {guard}")
    if len(pair_guards) != 8:
        raise SystemExit(f"{len(pair_guards)} pair-path calibrations ran, not 8")
    print(f"  the pair paths' guard held on {card_line}: "
          + "; ".join(f"{g['name']} {g['tail_slope'] / 1e9:.4f} GB a pair after the encode "
                      f"(whole call {g['slope'] / 1e9:.4f}) <= {g['per_pair'] / 1e9:.4f}"
                      for g in pair_guards)
          + f"; the pair calibrations took {sum(g['seconds'] for g in pair_guards):.1f} s",
          flush=True)
    line["hbm_guard_pairs"] = {"calibration": pair_guards, "refusal": sd15_out["refusal"]}
    line["kernel_domain"] = domain
    line["float32_scoring"] = {what: {k: v for k, v in res.items()
                                      if k not in ("counts", "scores", "guard", "pair_guard")}
                               for what, res in f32.items()}
    line["cli"] = {k: v for k, v in cli.items() if k not in ("counts", "fast_counts", "scores")}
    line["ip_adapter"] = {
        name: {k: out["ip"][k] for k in ("call_ms", "no_ip_call_ms", "peak_gib")}
        for name, out in (("sd15_512", sd15_out), ("sdxl_1024", xl_out))}
    line["cli_paths"] = {what: run["pairs_per_s"] for what, run in surface_cli.items()}
    line["baselines"] = {"full_width": baselines, "card_vs_cpu_tiny": tiny_baselines,
                         "cli": {what: {k: v for k, v in run.items() if k != "counts"}
                                 for what, run in baseline_cli.items()}}
    line["dit_train"] = {mode: {k: v for k, v in run.items() if k != "counts"}
                         for mode, run in train["runs"].items()}
    line["dit_sample"] = {mode: {k: v for k, v in run.items() if k not in ("counts", "images")}
                          for mode, run in sampled.items()}
    line["sam"] = {"vit_h_1024": sam_h, "cli": {k: v for k, v in sam_cli.items()
                                                   if k != "counts"}}
    line["serve"] = {k: v for k, v in served.items()
                     if k not in ("launches_round", "burst_scores", "paths")}
    line["rank"] = {k: v for k, v in ranked.items() if not k.startswith("launches")}
    # several ranks: torchrun at world size 1 over NCCL, two ranks on the one card
    # over gloo; the ranks' launches are in each entry's launches_paths
    line["ranks"] = {"torchrun_cli": {k: v for k, v in torchrun_cli.items() if k != "counts"},
                     "cli": {k: v for k, v in ranks_cli.items() if k != "launches"},
                     "serve": {k: v for k, v in ranks_served.items() if k != "launches"},
                     "dit_train": ranks_train, "dit_sample": ranks_sampled}
    line["sdxl_bf16_vae"] = {k: v for k, v in xl_bf16.items() if k != "counts"}
    line["dit"] = {"repeat_ms": dit_out["repeat_ms"], "peak_gib": dit_out["peak_gib"],
                   "cached_vs_fresh": dit_out["cached_gap"], "cli": dit_cli,
                   "converter": converted}
    print(f"  all phases done at {time.perf_counter() - START:.1f} s", flush=True)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
