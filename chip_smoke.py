#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``diffsim_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, on a machine with a CUDA card

Phases, each of which fails the run (non-zero exit, no result line) if anything in it fails:

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. the build: every ``diffsim_tpu_torch/csrc/*.cu`` compiled by nvcc for sm_90a, in parallel;
3. K1 ``fused_self_attention`` at the SD-1.5 main-path shapes (B = 24: 4 triplets x 6 CFG
   rows) and the SDXL ones (B = 12: 2 triplets), at S = 1280, in float32, and at every head
   dim it takes, against its plain version; timed beside the plain version,
   ``F.scaled_dot_product_attention`` (a yardstick only; the port never calls it), its
   previous design (v2, ``csrc/attention_v2.cu``, also held to the plain version) and the
   card's bound;
4. K2 ``fused_geglu_ff`` at its main-path shapes, the same way, beside its previous design
   (v2, ``csrc/geglu_ff_v2.cu``) and, as information, cuBLAS's two projections with PyTorch's
   elementwise GEGLU between them (no single PyTorch call computes GEGLU-FF, so K2 has no
   library time), and at ragged row counts and other widths in both dtypes;
5. K3 ``cross_self_partials`` (the fused readout) at the SDXL tap, (80, 1024, 64) bf16, in
   both similarities, at the SD-1.5 up-block-2/3 taps, at DiT's head dim 72 and in float32,
   scores against its plain version and its previous design (v2, ``csrc/fused_readout_v2.cu``);
   the kernel timed apart from the wrapper's per-pair torch epilogue, beside v2 and, as
   information, two 4-D ``scaled_dot_product_attention`` calls on the flash backend plus the
   reduction;
6. K4 ``streaming_self_attention`` at the 1024 px VAE mid attention (2, 1, 16384, 512) in
   float32 (the SDXL main path) and bf16, and at a ragged S = 8448, with SDPA as its library
   time and, in float32, its previous design (v2) beside it;
7. end-to-end correctness, card vs CPU from one seeded numpy weight tree and one
   ``noise_override``, in float32 with TF32 off: a tiny ``DiffSimSD15`` at 32 px (K1, K2) and a
   tiny ``DiffSimXL`` at 256 px (all four kernels);
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
   and an all-hit rescore bit for bit);
10. the bf16_probs mode (``--bf16_softmax``) of K1 at its SD-1.5 and SDXL shapes and in float32,
   and of K4 at the 1024 px VAE shape in both dtypes and at the 768 px SD-1.5 VAE shape,
   against their plain versions (atol = rtol = 1e-2), then on inputs with exact logits and
   each row's max at key 0 against a reference that rounds where the kernels round (float32
   within 1e-5, bf16 within half an output ulp, and at most a tenth of the exact mode's
   disagreement with it), timed beside the exact mode;
11. the 2AFC CLI at full SD-1.5 width: ``run_benchmark("cute", --preset cute ...)`` over a
   CUTE-shaped tree of 36 random 640 x 480 JPEGs (60 comparisons), through the device moment
   cache (one miss per image, the rest hits; 8 K1 and 4 K2 per UNet forward, no K3 or K4),
   again with ``--no_device_cache`` (scores within 1e-2), an all-hit rescore (bit for bit),
   and with ``--bf16_softmax`` (every K1 launch in the mode; scores within 0.05 of the exact
   run, not all equal); the SD-1.5 pair path in fast mode at 768 px, whose VAE mid attention
   (9216 tokens) runs K4 in the mode; and the device-memory guard's per-triplet constant held
   above the slope of the peak memory of the triplet path, measured between two triplet counts.

The line before the last is one JSON object ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. A kernel's time (``ms``), its library call's and its v2's are
device times that host work cannot enter: the CUPTI durations of the kernels each call launched,
from ``torch.profiler``, over 20 back-to-back calls after 3 warm-ups (the first launch sets
shared-memory limits), summed and divided by 20. They are timed in turns, twice, and each keeps
its lower reading. ``call_ms`` is the whole wrapper call between two CUDA events (median of 20),
host work included, as information; plain versions are timed that way too (5 calls for the
slowest). Each phase header prints the card's SM clock, power and throttle reasons: a card held
at its power limit lowers its clock. A bound is the largest of three times at the H100 SXM's
published dense peaks: the products (989 TFLOP/s bf16 tensor cores; K4 float32 three
TF32 passes at 495 TFLOP/s, 2.5 on average in its bf16_probs mode, whose P V takes two; 67
TFLOP/s float32 outside the tensor cores), the exponentials
(3.9e12/s on the special-function units, FlashAttention-3 section 1: b h s^2 for K1 and K4,
twice that per direction for K3) and the bytes (3.35 TB/s).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from diffsim_tpu_torch.cli.main import run_benchmark
from diffsim_tpu_torch.convert import bridge
from diffsim_tpu_torch.core.tokenizer import HashTokenizer
from diffsim_tpu_torch.data import benchmarks
from diffsim_tpu_torch.metrics.diffsim_sd15 import DiffSimSD15
from diffsim_tpu_torch.metrics.diffsim_xl import DiffSimXL
from diffsim_tpu_torch.metrics.scorer_base import to_device_pixels
from diffsim_tpu_torch.models.clip_text import CLIPText, CLIPTextConfig
from diffsim_tpu_torch.models.unet import UNet, UNetConfig
from diffsim_tpu_torch.models.vae import Encoder, VAEConfig, encode_chunked
from diffsim_tpu_torch.ops import kernels
from diffsim_tpu_torch.ops.kernels import build, readout
from diffsim_tpu_torch.ops.kernels.attention import (
    fused_self_attention, fused_self_attention_plain, round_bf16)
from diffsim_tpu_torch.ops.kernels.attention_stream import (
    streaming_self_attention,
    streaming_self_attention_plain,
)
from diffsim_tpu_torch.ops.kernels.ff import fused_geglu_ff, fused_geglu_ff_plain
from diffsim_tpu_torch.ops.kernels.readout import (
    cross_self_partials,
    fused_direction_score,
    fused_direction_score_plain,
)
from diffsim_tpu_torch.runtime import hbm_guard
from diffsim_tpu_torch.runtime.device_cache import resolve_cached_chunk

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM: bf16 tensor, FP32 SIMT
PEAK_TF32 = 495e12  # H100 SXM dense TF32 tensor cores: K4 float32 runs 3xTF32 passes
PEAK_EXP = 3.9e12  # exp/s of the H100 SXM's special-function units (FlashAttention-3, section 1)
PEAK_BYTES = 3.35e12  # HBM3 bandwidth, H100 SXM
CUTE = dict(prompt="The photo of a cat", target_block="up_blocks", target_layer=(0,),
            target_step=600, similarity="cosine", seed=2334)
XL_ARGS = dict(prompt="The photo of a benchmark", target_block="up_blocks",
               target_layer=(0, 1, 1), target_step=900, similarity="cosine", seed=2334)
BATCH = 24  # SD-1.5: 4 triplets x 3 images x 2 CFG halves
XL_T, XL_BATCH = 2, 12  # SDXL: 2 triplets (bench_backbones.py) x 3 images x 2 CFG halves
# (batch, heads, tokens, head dim): launches per SD-1.5 forward (canonical tap) and per SDXL
# triplet call (tap (0, 1, 1))
K1_SITES = {(BATCH, 8, 4096, 40): (2, 0), (BATCH, 8, 1024, 80): (2, 0),
            (BATCH, 8, 256, 160): (4, 0), (XL_BATCH, 10, 4096, 64): (0, 4),
            (XL_BATCH, 20, 1024, 64): (0, 41)}
K2_SITES = {(BATCH * 4096, 320): (2, 0), (BATCH * 1024, 640): (2, 0),
            (XL_BATCH * 4096, 640): (0, 4)}  # (rows, channels)
K3_MAIN = (XL_T * 2 * 20, 1024, 64)  # (P * B * heads, tokens, head dim) at the SDXL tap
K4_MAIN = (2, 1, 16384, 512)  # one VAE chunk of two 1024 px images
K4_768 = (2, 1, 9216, 512)  # the VAE mid attention of one SD-1.5 pair at 768 px
# K4's key tiles, whose row sums its bf16_probs mode rounds (csrc/streaming_attention.cu)
K4_SUM_TILE = {torch.float32: 64, torch.bfloat16: 32}
# the bf16_probs mode of K1 at the SD-1.5 main-path sites and one SDXL site, in bf16
K1_FAST_SITES = [(BATCH, 8, 4096, 40), (BATCH, 8, 1024, 80), (BATCH, 8, 256, 160),
                 (XL_BATCH, 20, 1024, 64)]
CLI_BATCH = 16  # comparisons per scoring call of the CLI phase (--batch_size)
# exact launches of each scoring call, derived from the configs (each kernel-routed site of
# the forward up to the tap, the readout's two directions per pair score, one K4 per VAE chunk)
NONE = dict.fromkeys(("fused_self_attention", "fused_geglu_ff", "cross_self_partials",
                      "streaming_self_attention"), 0)
SD15_CALL = {**NONE, "fused_self_attention": 8, "fused_geglu_ff": 4}
SD15_K3_CALL = {**NONE, "fused_self_attention": 11, "fused_geglu_ff": 6, "cross_self_partials": 2}
XL_FORWARD = {"fused_self_attention": 45, "fused_geglu_ff": 4}
XL_TRIPLET_CALL = {**XL_FORWARD, "cross_self_partials": 4, "streaming_self_attention": 3}
XL_PAIRS_CALL = {**XL_FORWARD, "cross_self_partials": 2, "streaming_self_attention": 2}
XL_ONE_PAIR_CALL = {**XL_FORWARD, "cross_self_partials": 2, "streaming_self_attention": 1}
TINY_SD15_CALL = {**NONE, "fused_self_attention": 3, "fused_geglu_ff": 3}  # K1: 2 UNet, 1 VAE
TINY_XL_CALL = {"fused_self_attention": 7, "fused_geglu_ff": 7, "cross_self_partials": 2,
                "streaming_self_attention": 1}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)
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


def device_ms(fn, reps: int = 20, warmup: int = 3) -> tuple[float, dict[str, float]]:
    """Device time of one call of ``fn`` in ms, which host work cannot enter: the CUPTI
    durations of the kernels it launched (``torch.profiler``) over ``reps`` back-to-back calls,
    summed and divided by ``reps``; and the same per kernel name."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for _ in range(2):  # a profiling session that records no kernel at all is taken again once
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():  # kernel entries only (an aten op's repeats its kernels')
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
                by_name[e.key] = by_name.get(e.key, 0.0) + e.self_device_time_total / 1e3 / reps
        if by_name:
            return sum(by_name.values()), by_name
    raise SystemExit("the profiler recorded no device time: kernel times not measured")


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
    gap any row has to its own max: key 0 holds every row's largest logit."""
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
    k[:, :, 0, 0] = float(np.ceil(gap))
    return q.to(dtype), k.to(dtype), v.to(dtype)


def rounded_probs_reference(q, k, v, sum_tile: int | None = None, tc_steps: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16_probs mode as the CUDA kernels round it, on :func:`planted_qkv` inputs, in
    float64: p = bf16(exp2(bf16(bf16(s - m) * bf16(scale)) * log2 e)) with exp2 in float32 as
    the kernels take it, and out = (P V) / l. K1 (``sum_tile`` None) rounds the row sum l of the
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
            x = round_bf16(round_bf16(logits - m) * scale_bf16)
            del logits
            p32 = torch.exp2(x * LOG2E)
            del x
            p = round_bf16(p32)
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


def check_rounding(name, kernel, shape, dtype, gen, sum_tile: int | None = None) -> dict:
    """Hold a kernel's bf16_probs mode to :func:`rounded_probs_reference` elementwise (float32:
    within 1e-5 + 1e-5 |ref|; bf16: within half a bf16 ulp, 2^-8 |ref|, + 1e-5; both plus the
    flippable roundings' allowance; bf16 kernels sum P V in the tensor cores over S/16 k16
    steps), and require its disagreement with the reference to be at most a tenth of the exact
    mode's on the same inputs. The mean signed error over the mean magnitude, towards zero
    negative, is printed as information (the tensor cores' truncation shows there)."""
    q, k, v = planted_qkv(shape, dtype, gen)
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
    best, kernels_of = {}, {}
    for _ in range(2):
        for key, fn in timed.items():
            ms, by_name = device_ms(fn)
            if key == "ms" and kernel_name is not None:
                ms = sum(t for name, t in by_name.items() if kernel_name in name)
                if ms == 0.0:
                    raise SystemExit(f"no kernel named like {kernel_name!r} in {sorted(by_name)}")
            if key not in best or ms < best[key]:
                best[key], kernels_of[key] = ms, by_name
    row.update(best)
    row.setdefault("library_ms", None)
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
    "streaming_attention_v2_fwd": ("attention_v2", [_P] * 4 + [_I] * 3 + [_F, _P]),
    "geglu_ff_v2_fwd": ("geglu_ff_v2", [_P] * 7 + [_I, _I, _P]),
    "fused_readout_v2_fwd": ("fused_readout_v2", [_P] * 6 + [_I] * 3 + [_F, _I, _P]),
}


def _yardstick(name: str, *args) -> None:
    lib_name, argtypes = YARDSTICKS[name]
    lib = build.library(lib_name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    build.check(lib, fn(*args, torch.cuda.current_stream().cuda_stream), name)


def v2_kernel(name: str, q, k, v):
    """The previous design of K1 (bf16) or K4 (float32) on the same inputs."""
    b, h, s, d = q.shape
    out = torch.empty_like(v)
    _yardstick(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, s, d,
               float(d**-0.5))
    return out


def v2_geglu_ff(x, w1, b1, w2, b2):
    """The previous design of K2 (bf16) on the same inputs."""
    n, c = x.shape
    y = torch.empty((n, 4 * c), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    _yardstick("geglu_ff_v2_fwd", *(t.data_ptr() for t in (x, w1, b1, w2, b2, y, out)), n, c)
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
            row["launches_sd15_forward"], row["launches_sdxl_call"] = K1_SITES[(b, h, s, d)]
            v2 = lambda: v2_kernel("fused_attention_v2_fwd", q, k, v)  # noqa: E731
            check_close(f"K1 v2 {(b, h, s, d)}", v2(), ref, *tol, quiet=True)
            _timed(row, lambda: fused_self_attention(q, k, v),
                   lambda: fused_self_attention_plain(q, k, v),
                   4 * b * h * s * s * d, 4 * b * h * s * d * q.element_size(),
                   library=lambda: F.scaled_dot_product_attention(q, k, v), v2=v2,
                   exps=b * h * s * s)
        rows.append(row)
        del q, k, v, ref
        torch.cuda.empty_cache()
    # every head dim the kernel takes (D % 8 == 0, D <= 160: ten padded widths), two S
    errs = []
    for d in range(8, 161, 8):
        for s in (64, 192):
            q, k, v = (torch.randn((2, 3, s, d), generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(3))
            errs.append(check_close(f"K1 {(2, 3, s, d)} bf16", fused_self_attention(q, k, v),
                                    fused_self_attention_plain(q, k, v), 1e-2, 1e-2, quiet=True))
    print(f"  K1 at every D in 8..160 step 8, S in (64, 192), bf16: max|kernel - plain| = "
          f"{max(errs):.3e} ok", flush=True)
    return {"rows": rows, "max_abs_err": main_err}


def k2_phase(gen) -> dict:
    phase("K2 fused_geglu_ff vs plain (bf16 atol=rtol=1e-2, float32 atol=rtol=1e-4)")
    rows, main_err = [], 0.0

    def rand(shape, scale, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    for (n, c), launches in K2_SITES.items():
        x = rand((n, c), 1.0)
        w1, b1 = rand((8 * c, c), c**-0.5), rand((8 * c,), 0.1)
        w2, b2 = rand((c, 4 * c), (4 * c) ** -0.5), rand((c,), 0.1)
        args = (x, w1, b1, w2, b2)
        out = fused_geglu_ff(*args)
        torch.cuda.synchronize()
        err = check_close(f"K2 {(n, c)} bf16", out, fused_geglu_ff_plain(*args), 1e-2, 1e-2)
        main_err = max(main_err, err)
        check_close(f"K2 v2 {(n, c)}", v2_geglu_ff(*args), out, 1e-2, 1e-2, quiet=True)
        row = {"shape": [n, c], "dtype": "bfloat16", "max_abs_err": err,
               "launches_sd15_forward": launches[0], "launches_sdxl_call": launches[1]}
        _timed(row, lambda: fused_geglu_ff(*args), lambda: fused_geglu_ff_plain(*args),
               24 * n * c * c, (2 * n * c + 12 * c * c + 9 * c) * 2,
               v2=lambda: v2_geglu_ff(*args),
               info={"cublas_path_ms": lambda: _cublas_geglu_ff(*args)})
        rows.append(row)
        del x, w1, b1, w2, b2, args, out
        torch.cuda.empty_cache()
    # ragged row counts and other widths, both dtypes (float32 at atol = rtol = 1e-4)
    for n, c in [(8, 32), (300, 32), (1000, 64), (136, 160), (24 * 256, 1280)]:
        for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
            args = (rand((n, c), 1.0, dtype), rand((8 * c, c), c**-0.5, dtype),
                    rand((8 * c,), 0.1, dtype), rand((c, 4 * c), (4 * c) ** -0.5, dtype),
                    rand((c,), 0.1, dtype))
            check_close(f"K2 {(n, c)} {dtype}", fused_geglu_ff(*args),
                        fused_geglu_ff_plain(*args), tol, tol)
    return {"rows": rows, "max_abs_err": main_err}


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


def k3_phase(gen) -> dict:
    phase("K3 cross_self_partials (fused readout) vs plain: scores, bf16 atol 1e-3 and rtol 1e-3 "
          "of the distance, float32 atol 1e-5 and rtol 1e-5")
    v2_score = functools.partial(readout._direction_score,
                                 readout_partials("fused_readout_v2_fwd"))
    # (P, B, H, S, D): the SDXL tap of the main path (N = 80), the SD-1.5 up-block-2/3 taps of
    # a 2-pair score_batch, DiT-XL/2's head dim 72, and the SDXL tap in float32
    shapes = [((XL_T, 2, 20, 1024, 64), torch.bfloat16), ((2, 2, 8, 1024, 80), torch.bfloat16),
              ((2, 2, 8, 4096, 40), torch.bfloat16), ((2, 2, 16, 1024, 72), torch.bfloat16),
              ((XL_T, 2, 20, 1024, 64), torch.float32)]
    rows, main_err = [], 0.0
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
        main = (n, s, d) == K3_MAIN and dtype == torch.bfloat16
        for similarity in ("cosine", "mse"):
            out = fused_direction_score(*taps, similarity)
            torch.cuda.synchronize()
            ref = fused_direction_score_plain(*taps, similarity)
            tol = 1e-3 if dtype == torch.bfloat16 else 1e-5
            err = check_score(f"K3 {shape} {dtype} {similarity}", out, ref, similarity, tol, tol)
            row = {"shape": [n, s, d], "taps": list(shape), "similarity": similarity,
                   "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err}
            if main:
                main_err = max(main_err, err)
                row["launches_sdxl_call"] = 4 if similarity == "cosine" else 0
            bf16 = dtype == torch.bfloat16
            if bf16:
                check_score(f"K3 v2 {shape} {similarity}", v2_score(*taps, similarity), ref,
                            similarity, tol, tol)
            if similarity == "cosine" and (main or not bf16 or d == 80):
                flat = [x.reshape(n, s, d) for x in (taps[0], taps[3], taps[4], taps[1], taps[2])]
                info = {"sdpa_pair_ms": lambda: _sdpa_readout(taps, similarity)}
                _timed(row, lambda: cross_self_partials(*flat),
                       lambda: fused_direction_score_plain(*taps, similarity),
                       8 * n * s * s * d, 5 * n * s * d * taps[0].element_size(),
                       v2=(lambda: readout_launch("fused_readout_v2_fwd", *flat)) if bf16
                       else None, info=info, kernel_name="readout_",
                       call=lambda: fused_direction_score(*taps, similarity), dtype=dtype,
                       plain_reps=5, exps=2 * n * s * s)
                row["epilogue_ms"] = row["call_device_ms"] - row["ms"]
            rows.append(row)
        del taps
        torch.cuda.empty_cache()
    return {"rows": rows, "max_abs_err": main_err}


def k4_phase(gen) -> dict:
    phase("K4 streaming_self_attention vs plain (float32 atol 1e-5, bf16 atol=rtol=1e-2)")
    shapes = [(K4_MAIN, torch.float32), (K4_MAIN, torch.bfloat16),
              ((1, 1, 8448, 512), torch.float32), ((1, 1, 8448, 512), torch.bfloat16)]
    rows, main_err = [], 0.0
    for shape, dtype in shapes:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
        out = streaming_self_attention(q, k, v)
        torch.cuda.synchronize()
        ref = streaming_self_attention_plain(q, k, v)
        tol = (1e-5, 0.0) if dtype == torch.float32 else (1e-2, 1e-2)
        err = check_close(f"K4 {shape} {dtype}", out, ref, *tol)
        del out
        row = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": err}
        if shape == K4_MAIN:
            b, h, s, d = shape
            v2 = None
            if dtype == torch.float32:
                main_err = err
                row["launches_sdxl_call"] = 3
                v2 = lambda: v2_kernel("streaming_attention_v2_fwd", q, k, v)  # noqa: E731
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
    return {"rows": rows, "max_abs_err": main_err}


def _random_tree(factory, kind: str, rng) -> dict:
    """A seeded numpy parameter tree in the JAX package's layout for the module ``factory``
    builds: matrices N(0, 0.1), norm scales 1 + N(0, 0.1), biases N(0, 0.05)."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in factory().state_dict().items()}
    state = {}
    for name, shape in shapes.items():
        draw = rng.standard_normal(shape).astype(np.float32)
        if name.endswith("bias"):
            state[name] = draw * 0.05
        elif len(shape) == 1:
            state[name] = 1.0 + draw * 0.1
        else:
            state[name] = draw * 0.1
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


def _card_vs_cpu(name, make_scorer, pix_a, pix_b, noise, args, expected) -> None:
    for similarity in ("cosine", "mse"):
        scores = {}
        for device in ("cuda", "cpu"):
            scorer = make_scorer(device)
            kernels.reset_launch_counts()
            scores[device] = scorer.score_batch(pix_a, pix_b, **{**args, "similarity": similarity},
                                                noise_override=noise)
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
    with tf32_off():
        _card_vs_cpu("tiny SDXL", lambda device: DiffSimXL(
            params, img_size=256, dtype=torch.float32, device=device,
            tokenizer=HashTokenizer(1000), **cfgs), pix_a, pix_b, noise, XL_ARGS, TINY_XL_CALL)


def _checked_call(name: str, fn, expected: dict):
    """Run one scoring call with the launch counts at zero; fail unless it launched exactly the
    ``expected`` kernels."""
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"  {name}: launches {counts}", flush=True)
    if counts != {**NONE, **expected}:
        raise SystemExit(f"{name}: expected launches {expected}")
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
    return out


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
    phase("SDXL through the device moment cache: score_triplet_paths on the same two triplets")
    sdxl_cached(scorer, pix, *out["scores"])
    out["guard"] = guard_slope("SDXL 1024 px", scorer, XL_ARGS, (2, 4), 1024, card_line)
    return out


def _mode_row(row, kernel, plain, flops, nbytes, *, exact, dtype, exps, tf32_passes=0.0,
              plain_reps=20):
    """Time a kernel's bf16_probs mode as ``_timed`` does, with its exact mode and SDPA (exact
    float32 or bf16 softmax) beside it as information: no PyTorch call computes attention with
    bf16 probabilities, so the mode has no library time."""
    q, k, v = exact
    _timed(row, kernel, plain, flops, nbytes, dtype=dtype, exps=exps, tf32_passes=tf32_passes,
           plain_reps=plain_reps,
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
        row["rounding"] = check_rounding(f"K1 bf16_probs {(b, h, s, d)} {dtype}",
                                         fused_self_attention, (b, h, s, d), dtype, gen)
        torch.cuda.empty_cache()
        if K1_SITES.get((b, h, s, d), (0,))[0] and dtype == torch.bfloat16:
            main_err = max(main_err, err)  # the sites of the SD-1.5 tail in fast mode
            row["launches_sd15_forward"] = K1_SITES[(b, h, s, d)][0]
            _mode_row(row, lambda: fused_self_attention(q, k, v, True),
                      lambda: fused_self_attention_plain(q, k, v, True),
                      4 * b * h * s * s * d, 4 * b * h * s * d * q.element_size(),
                      exact=(q, k, v), dtype=dtype, exps=b * h * s * s)
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
    report, adapter = run_benchmark("cute", argv)
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


def cli_phase(card_line: str) -> dict:
    phase("the 2AFC CLI at full SD-1.5 width: cute --preset cute, 60 comparisons over 36 "
          "random JPEGs, through the device moment cache; --no_device_cache; an all-hit "
          "rescore; --bf16_softmax")
    with tempfile.TemporaryDirectory() as tmp:
        tree = _cute_tree(tmp)
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
    return {"counts": counts, "fast_counts": fast_modes, "forwards": calls,
            "hit_rate": hit_rate, "stats": stats,
            "pairs_per_s": {"cached": 120 / wall, "no_device_cache": 120 / fresh_wall,
                            "bf16_softmax": 120 / fast_wall, "all_hit_rescore": 120 / rescore_s},
            "cached_vs_fresh": gap, "fast_vs_exact": fast_gap}


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


def sdxl_cached(scorer, pix, s_ab, s_ac) -> None:
    """``score_triplet_paths`` on the SDXL phase's two triplets written to disk as PNGs: within
    1e-2 of ``score_triplet_batch`` (the miss slab and the fresh batch encode different numbers
    of images at once), and an all-hit rescore bit for bit."""
    from PIL import Image

    with tempfile.TemporaryDirectory() as tmp:
        roles = []
        for r, arr in zip("abc", pix):
            roles.append([os.path.join(tmp, f"{r}{i}.png") for i in range(len(arr))])
            for path, img in zip(roles[-1], arr):
                Image.fromarray(img).save(path)
        # six images in one miss slab: three 2-image VAE slices
        (c_ab, c_ac), _ = _checked_call("score_triplet_paths (2 triplets, all misses)",
                                        lambda: scorer.score_triplet_paths(*roles, **XL_ARGS),
                                        XL_TRIPLET_CALL)
        (h_ab, h_ac), _ = _checked_call("score_triplet_paths (2 triplets, all hits)",
                                        lambda: scorer.score_triplet_paths(*roles, **XL_ARGS),
                                        {**XL_FORWARD, "cross_self_partials": 4})
    gap = max(np.abs(c_ab - s_ab).max(), np.abs(c_ac - s_ac).max())
    print(f"  cached {c_ab} {c_ac} vs fresh: max |d| = {gap:.3e} (limit 1e-2); cache "
          f"{scorer._moment_cache.stats}", flush=True)
    if gap > 1e-2 or not (np.array_equal(h_ab, c_ab) and np.array_equal(h_ac, c_ac)):
        raise SystemExit("SDXL score_triplet_paths disagrees with the fresh path or itself")


def profile_call(fn, what: str, top: int = 14) -> None:
    """Device time by kernel over one call, from torch.profiler (information for PERF.md):
    the device's busy time is the sum of kernel self times (one stream, no overlap)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel entries only: an aten op's own entry repeats the device time of its kernels
    kern = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA), key=lambda r: -r[2])
    kern = [r for r in kern if r[2] > 0]
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
           "peak": rows[0]["peak"]}
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
XL_PER = f"one SDXL score_triplet_batch call ({XL_T} triplets, 1024 px), the sum over its launches"


def _path(result, launches, key, per) -> dict:
    return {"launches": launches, **_totals(result["rows"], key), "per": per}


def kernel_entry(name, source, replaces, design, result, path, sdxl=None) -> dict:
    """One kernel's entry of the kernels line. ``path`` = (launches, row key, per) gives the
    top-level numbers, summed over one call of the path the kernel was ported on: one SD-1.5
    UNet forward for K1 and K2 (as the first slice reported them), one SDXL triplet call for
    K3 and K4. ``sdxl`` gives K1's and K2's numbers over one SDXL triplet call, under "sdxl"."""
    entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "design": design, "max_abs_err": result["max_abs_err"], **_path(result, *path)}
    if sdxl is not None:
        entry["sdxl"] = _path(result, *sdxl)
    entry["shapes"] = result["rows"]
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    phase("card")
    card_line = card()
    phase("build")
    t0 = time.perf_counter()
    reports = build.build(build.SOURCES + build.BASELINES)
    print(f"  built {sorted(reports) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    k1 = k1_phase(gen)
    k2 = k2_phase(gen)
    k3 = k3_phase(gen)
    k4 = k4_phase(gen)
    k1_fast = k1_fast_phase(gen)
    k4_fast = k4_fast_phase(gen)
    tiny_phase()
    tiny_xl_phase()
    sd15_out = sd15_phase(card_line)
    sd15 = sd15_out["counts"]
    torch.cuda.empty_cache()
    cli = cli_phase(card_line)
    fast768 = sd15_fast_768_phase()
    xl_out = sdxl_phase(card_line)
    xl = xl_out["counts"]

    def on_sd15(kernel):
        return sd15[kernel], "launches_sd15_forward", SD15_PER

    def on_xl(kernel):
        return xl[kernel], "launches_sdxl_call", XL_PER

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
        "diffsim_tpu/ops/pallas/attention_stream.py:62", "mma.sync (bf16), bf16_probs "
        "instantiation; float32: 3xTF32 Q K^T, 2 TF32 products for P V", k4_fast,
        (fast768["fast_counts"]["streaming_self_attention"], "launches_sd15_768_pair",
         "one SD-1.5 score_batch pair in fast mode at 768 px"))

    line = {"kernels": [
        kernel_entry("fused_self_attention", "diffsim_tpu_torch/csrc/fused_attention.cu",
                     "diffsim_tpu/ops/pallas/attention.py:101", K1_DESIGN, k1,
                     on_sd15("fused_self_attention"), on_xl("fused_self_attention")),
        kernel_entry("fused_geglu_ff", "diffsim_tpu_torch/csrc/geglu_ff.cu",
                     "diffsim_tpu/ops/pallas/ff.py:75", K2_DESIGN, k2,
                     on_sd15("fused_geglu_ff"), on_xl("fused_geglu_ff")),
        kernel_entry("cross_self_partials", "diffsim_tpu_torch/csrc/fused_readout.cu",
                     "diffsim_tpu/ops/pallas/readout.py:71", K3_DESIGN, k3,
                     on_xl("cross_self_partials")),
        kernel_entry("streaming_self_attention", "diffsim_tpu_torch/csrc/streaming_attention.cu",
                     "diffsim_tpu/ops/pallas/attention_stream.py:94", K4_DESIGN, k4,
                     on_xl("streaming_self_attention")),
        fast_k1,
        fast_k4,
    ]}
    for entry in line["kernels"][:2]:  # K1 and K2 on this slice's main path, the CLI run
        entry["launches_cli"] = cli["counts"][entry["name"]]
    k1_xl = line["kernels"][0]["sdxl"]
    k2_sd, k2_xl = line["kernels"][1], line["kernels"][1]["sdxl"]
    k3_xl = line["kernels"][2]
    k4_row = next(r for r in k4["rows"] if r.get("launches_sdxl_call"))
    print(f"  device-only kernel times on {card_line}:\n"
          f"  K1 per SDXL triplet call {k1_xl['ms']:.3f} ms (v2 {k1_xl['v2_ms']:.3f}, SDPA "
          f"{k1_xl['library_ms']:.3f}); K2 per SD-1.5 forward {k2_sd['ms']:.3f} ms (v2 "
          f"{k2_sd['v2_ms']:.3f}, cuBLAS path {k2_sd['cublas_path_ms']:.3f}), per SDXL call "
          f"{k2_xl['ms']:.3f} (v2 {k2_xl['v2_ms']:.3f}, cuBLAS path "
          f"{k2_xl['cublas_path_ms']:.3f}); K3 per SDXL call {k3_xl['ms']:.3f} ms (v2 "
          f"{k3_xl['v2_ms']:.3f}; the wrapper's torch epilogue {k3_xl['epilogue_ms']:.3f} on the "
          f"device, the whole calls {k3_xl['call_ms']:.3f} by CUDA events); K4 float32 per "
          f"launch {k4_row['ms']:.3f} ms (v2 {k4_row['v2_ms']:.3f}, SDPA "
          f"{k4_row['library_ms']:.3f})", flush=True)
    print(f"  bf16_probs mode: K1 per SD-1.5 forward {fast_k1['ms']:.3f} ms (exact "
          f"{fast_k1['exact_ms']:.3f}); K4 at {K4_768} bf16 {fast_k4['ms']:.3f} ms (exact "
          f"{fast_k4['exact_ms']:.3f}). CLI: hit rate {cli['hit_rate']:.4f}, pairs/s "
          f"{cli['pairs_per_s']}, cached vs fresh {cli['cached_vs_fresh']:.3e}, fast vs exact "
          f"{cli['fast_vs_exact']:.3e}", flush=True)
    for guard in (sd15_out["guard"], xl_out["guard"]):
        if (guard["per_triplet"] < guard["slope"] or guard["encode_bytes"] < guard["encode_peak"]
                or any(guard["estimates"][t] < guard["peaks"][t] for t in guard["peaks"])):
            raise SystemExit(f"{guard['name']}: the device-memory guard's constants are below "
                             f"what the card measured: {guard}")
    line["hbm_guard"] = [sd15_out["guard"], xl_out["guard"]]
    line["cli"] = {k: v for k, v in cli.items() if k not in ("counts", "fast_counts")}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
