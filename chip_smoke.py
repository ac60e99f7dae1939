#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``diffsim_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, on a machine with a CUDA card

Phases, each of which fails the run (non-zero exit, no result line) if anything in it fails:

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. the build: every ``diffsim_tpu_torch/csrc/*.cu`` compiled by nvcc for sm_90a, in parallel;
3. K1 ``fused_self_attention`` at the SD-1.5 main-path shapes (B = 24: 4 triplets x 6 CFG
   rows), at S = 1280, in float32, and at every head dim it takes, against its plain version;
   timed beside the plain version, ``F.scaled_dot_product_attention`` (a yardstick only; the
   port never calls it) and the card's bound;
4. K2 ``fused_geglu_ff`` at its two main-path shapes, the same way (no single PyTorch call
   computes GEGLU-FF, so K2 has no library time), and at ragged row counts and other widths
   in both dtypes;
5. end-to-end correctness: a tiny float32 ``DiffSimSD15`` at 32 px (256-token latents, so K1
   and K2 route) scored on the card and on the CPU from one seeded numpy weight tree and one
   ``noise_override``, with TF32 off;
6. the main path at full SD-1.5 width: ``DiffSimSD15(img_size=512)`` in bf16 with random weights
   drawn on the card, ``score_triplet_batch`` on 4 triplets with the canonical CUTE arguments,
   ``score_batch`` on 2 pairs and ``diffsim`` on two PNG paths, counting kernel launches per
   UNet forward (8 K1, 4 K2).

The line before the last is one JSON object ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Timings use CUDA events (median of 20 after 3 warm-ups).
Bounds use the H100 SXM's published dense peaks: 989 TFLOP/s bf16 tensor cores, 3.35 TB/s.
"""

from __future__ import annotations

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

from diffsim_tpu_torch.convert import bridge
from diffsim_tpu_torch.core.tokenizer import HashTokenizer
from diffsim_tpu_torch.metrics.diffsim_sd15 import DiffSimSD15
from diffsim_tpu_torch.models.clip_text import CLIPText, CLIPTextConfig
from diffsim_tpu_torch.models.unet import UNet, UNetConfig
from diffsim_tpu_torch.models.vae import Encoder, VAEConfig
from diffsim_tpu_torch.ops import kernels
from diffsim_tpu_torch.ops.kernels import build
from diffsim_tpu_torch.ops.kernels.attention import fused_self_attention, fused_self_attention_plain
from diffsim_tpu_torch.ops.kernels.ff import fused_geglu_ff, fused_geglu_ff_plain

PEAK_FLOPS = 989e12  # bf16 dense tensor-core peak, H100 SXM
PEAK_BYTES = 3.35e12  # HBM3 bandwidth, H100 SXM
CUTE = dict(prompt="The photo of a cat", target_block="up_blocks", target_layer=(0,),
            target_step=600, similarity="cosine", seed=2334)
# one UNet forward at the canonical tap: K1 sites (tokens, head dim, launches per forward)
K1_SITES = [(4096, 40, 2), (1024, 80, 2), (256, 160, 4)]
K2_SITES = [(4096, 320, 2), (1024, 640, 2)]  # (tokens, channels, launches per forward)
BATCH = 24  # 4 triplets x 3 images x 2 CFG halves


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms over ``reps`` runs, each between two CUDA events."""
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


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_close(name, out, ref, atol, rtol, quiet: bool = False) -> float:
    err = (out.float() - ref.float()).abs().max().item()
    ok = torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol)
    if not quiet or not ok:
        print(f"  {name}: max|kernel - plain| = {err:.3e} (atol {atol}, rtol {rtol}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok or not torch.isfinite(out).all():
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    return err


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0 = {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    return line


def k1_phase(gen) -> dict:
    phase("K1 fused_self_attention vs plain (bf16 atol=rtol=1e-2, float32 atol=1e-5)")
    shapes = [(BATCH, 8, s, d, torch.bfloat16) for s, d, _ in K1_SITES]
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
        del out, ref
        row = {"shape": [b, h, s, d], "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": err}
        if (s, d) in [(s_, d_) for s_, d_, _ in K1_SITES] and b == BATCH:
            main_err = max(main_err, err)
            row["ms"] = time_ms(lambda: fused_self_attention(q, k, v))
            row["plain_ms"] = time_ms(lambda: fused_self_attention_plain(q, k, v))
            row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            row["bound_ms"], row["bound_by"] = bound(4 * b * h * s * s * d,
                                                     4 * b * h * s * d * q.element_size())
            print(f"    ms {row['ms']:.4f}  plain {row['plain_ms']:.4f}  "
                  f"sdpa {row['library_ms']:.4f}  bound {row['bound_ms']:.4f} "
                  f"({row['bound_by']})", flush=True)
        rows.append(row)
        del q, k, v
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
    phase("K2 fused_geglu_ff vs plain (bf16 atol=rtol=1e-2)")
    rows, main_err = [], 0.0
    for tokens, c, _ in K2_SITES:
        n = BATCH * tokens

        def rand(shape, scale):
            return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

        x = rand((n, c), 1.0)
        w1, b1 = rand((8 * c, c), c**-0.5), rand((8 * c,), 0.1)
        w2, b2 = rand((c, 4 * c), (4 * c) ** -0.5), rand((c,), 0.1)
        args = (x, w1, b1, w2, b2)
        out = fused_geglu_ff(*args)
        torch.cuda.synchronize()
        err = check_close(f"K2 {(n, c)} bf16", out, fused_geglu_ff_plain(*args), 1e-2, 1e-2)
        main_err = max(main_err, err)
        row = {"shape": [n, c], "dtype": "bfloat16", "max_abs_err": err,
               "ms": time_ms(lambda: fused_geglu_ff(*args)),
               "plain_ms": time_ms(lambda: fused_geglu_ff_plain(*args)),
               "library_ms": None}
        nbytes = (2 * n * c + 12 * c * c + 9 * c) * 2
        row["bound_ms"], row["bound_by"] = bound(24 * n * c * c, nbytes)
        print(f"    ms {row['ms']:.4f}  plain {row['plain_ms']:.4f}  bound "
              f"{row['bound_ms']:.4f} ({row['bound_by']})", flush=True)
        rows.append(row)
        del x, w1, b1, w2, b2, args, out
        torch.cuda.empty_cache()
    # ragged row counts and other widths, both dtypes (float32 at atol = rtol = 1e-4)
    for n, c in [(8, 32), (300, 32), (1000, 64), (136, 160), (24 * 256, 1280)]:
        for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
            args = tuple((torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)
                         for shape, scale in [((n, c), 1.0), ((8 * c, c), c**-0.5),
                                              ((8 * c,), 0.1), ((c, 4 * c), (4 * c) ** -0.5),
                                              ((c,), 0.1)])
            check_close(f"K2 {(n, c)} {dtype}", fused_geglu_ff(*args),
                        fused_geglu_ff_plain(*args), tol, tol)
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


def tiny_phase() -> None:
    phase("end to end, tiny config at 32 px in float32: card vs CPU (|dscore| <= 1e-4)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("  torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False")
    rng = np.random.default_rng(2334)
    cfgs = dict(unet_cfg=UNetConfig.tiny(), vae_cfg=VAEConfig.tiny(),
                text_cfg=CLIPTextConfig.tiny())
    params = {"unet": _random_tree(lambda: UNet(cfgs["unet_cfg"]), "unet", rng),
              "vae": _random_tree(lambda: Encoder(cfgs["vae_cfg"]), "vae", rng),
              "text": _random_tree(lambda: CLIPText(cfgs["text_cfg"]), "text", rng)}
    pix_a, pix_b = (rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8) for _ in range(2))
    noise = tuple(rng.standard_normal((2, 16, 16, 4)).astype(np.float32) for _ in range(2))
    for similarity in ("cosine", "mse"):
        scores = {}
        for device in ("cuda", "cpu"):
            scorer = DiffSimSD15(params, img_size=32, dtype=torch.float32, device=device,
                                 tokenizer=HashTokenizer(cfgs["text_cfg"].vocab_size), **cfgs)
            kernels.reset_launch_counts()
            scores[device] = scorer.score_batch(pix_a, pix_b, **{**CUTE, "similarity": similarity},
                                                noise_override=noise)
            counts = kernels.launch_counts()
            if device == "cuda":
                print(f"  launches on the card ({similarity}): {counts}")
                if min(counts.values()) == 0:
                    raise SystemExit("tiny run: a kernel of the path did not launch")
        delta = float(np.abs(scores["cuda"] - scores["cpu"]).max())
        print(f"  {similarity}: card {scores['cuda']}, cpu {scores['cpu']}, "
              f"max|d| = {delta:.3e}", flush=True)
        if not (np.isfinite(scores["cuda"]).all() and delta <= 1e-4):
            raise SystemExit("tiny run: the card disagrees with the CPU")


def _checked_call(name: str, fn):
    """Run one scoring call with the launch counts at zero; fail unless it launched exactly one
    UNet forward's worth of kernels (8 K1, 4 K2)."""
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"  {name}: launches {counts}", flush=True)
    if counts != {"fused_self_attention": 8, "fused_geglu_ff": 4}:
        raise SystemExit(f"{name}: expected 8 K1 and 4 K2 launches per UNet forward")
    return out, counts


def _check_scores(name: str, *arrays) -> None:
    for a in arrays:
        if not (np.isfinite(a).all() and (np.abs(a) <= 1.0 + 1e-6).all()):
            raise SystemExit(f"{name}: scores not finite in [-1, 1]: {a}")


def main_path_phase(card_line: str) -> dict:
    phase("main path: SD-1.5 at full width, 512 px, bf16, canonical CUTE tap")
    t0 = time.perf_counter()
    scorer = DiffSimSD15(img_size=512)  # cuda, bf16, random weights from a seeded generator
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (scorer.unet, scorer.vae, scorer.text)
                   for p in m.parameters())
    print(f"  init {time.perf_counter() - t0:.2f} s, {n_params / 1e6:.1f} M parameters")
    rng = np.random.default_rng(0)
    pix_a, pix_b, pix_c = (rng.integers(0, 256, (4, 512, 512, 3), dtype=np.uint8)
                           for _ in range(3))
    torch.cuda.reset_peak_memory_stats()
    (s_ab, s_ac), counts = _checked_call(
        "score_triplet_batch (4 triplets)", lambda: scorer.score_triplet_batch(
            pix_a, pix_b, pix_c, **CUTE))
    _check_scores("score_triplet_batch", s_ab, s_ac)
    t0 = time.perf_counter()
    again_ab, again_ac = scorer.score_triplet_batch(pix_a, pix_b, pix_c, **CUTE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not (np.array_equal(again_ab, s_ab) and np.array_equal(again_ac, s_ac)):
        raise SystemExit("score_triplet_batch: a repeat call gave other scores")
    print(f"  s_ab {s_ab}\n  s_ac {s_ac}")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  repeat call {wall * 1e3:.1f} ms: {8 / wall:.2f} pairs/s on {card_line} "
          "(information only, not a benchmark)", flush=True)
    pairs, _ = _checked_call("score_batch (2 pairs)", lambda: scorer.score_batch(
        pix_a[:2], pix_b[:2], **CUTE))
    _check_scores("score_batch", pairs)
    print(f"  score_batch {pairs} vs s_ab[:2] {s_ab[:2]}")
    if not np.allclose(pairs, s_ab[:2], atol=1e-2):
        raise SystemExit("score_batch disagrees with score_triplet_batch's s_ab beyond 1e-2")
    from PIL import Image

    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"{i}.png") for i in range(2)]
        for path, arr in zip(paths, (pix_a[0], pix_b[0])):
            Image.fromarray(arr).save(path)
        score, _ = _checked_call("diffsim(a.png, b.png)",
                                 lambda: scorer.diffsim(paths[0], paths[1], **CUTE))
    _check_scores("diffsim", np.array([score]))
    print(f"  diffsim(a.png, b.png) = {score}", flush=True)
    profile_call(lambda: scorer.score_triplet_batch(pix_a, pix_b, pix_c, **CUTE))
    return counts


def profile_call(fn, top: int = 12) -> None:
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
    print(f"  profile of one triplet call: wall {wall_ms:.1f} ms under the profiler, device "
          f"busy {busy:.1f} ms ({100 * busy / wall_ms:.1f} %) in {sum(r[1] for r in kern)} "
          "kernel launches; top kernels by device time:")
    for name, count, ms in kern[:top]:
        print(f"    {ms:8.2f} ms {100 * ms / busy:5.1f} % x{count:<4d} {name[:100]}")


def kernel_entry(name, source, replaces, launches, result, keys) -> dict:
    """One kernel's entry of the kernels line. Its times are summed over one UNet forward's
    launches at B = 24: ``keys`` maps each main-path row's trailing shape to its launches per
    forward."""
    rows = [(r, keys[tuple(r["shape"][-2:])]) for r in result["rows"]
            if tuple(r["shape"][-2:]) in keys and "ms" in r]

    def total(key):
        if any(r[key] is None for r, _ in rows):
            return None
        return sum(r[key] * n for r, n in rows)

    ms, bound_ms = total("ms"), total("bound_ms")
    ops_ms = sum(r["bound_ms"] * n for r, n in rows if r["bound_by"] == "operations")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": result["max_abs_err"], "ms": ms,
            "plain_ms": total("plain_ms"), "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bound_ms / 2 else "bytes",
            "library_ms": total("library_ms"), "roofline_share": bound_ms / ms,
            "per": "one UNet forward at B=24 (sum over its launches)",
            "shapes": result["rows"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    phase("card")
    card_line = card()
    phase("build")
    t0 = time.perf_counter()
    reports = build.build()
    print(f"  built {sorted(reports) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    k1 = k1_phase(gen)
    k2 = k2_phase(gen)
    tiny_phase()
    counts = main_path_phase(card_line)
    line = {"kernels": [
        kernel_entry("fused_self_attention", "diffsim_tpu_torch/csrc/fused_attention.cu",
                     "diffsim_tpu/ops/pallas/attention.py:101", counts["fused_self_attention"],
                     k1, {(s, d): n for s, d, n in K1_SITES}),
        kernel_entry("fused_geglu_ff", "diffsim_tpu_torch/csrc/geglu_ff.cu",
                     "diffsim_tpu/ops/pallas/ff.py:75", counts["fused_geglu_ff"], k2,
                     {(BATCH * s, c): n for s, c, n in K2_SITES}),
    ]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
