"""Pre-flight device-memory budget for the scoring paths (counterpart of
``diffsim_tpu/runtime/hbm_guard.py``).

Every triplet dispatch (fresh pixels and cached moments, SD-1.5 and SDXL) estimates its peak
device memory on the host before it runs, takes the largest chunk of triplets that fits when
the caller gives none, and refuses an explicit chunk that does not fit with
:class:`HbmBudgetError`, before anything reaches the card. Eager PyTorch frees each chunk's
activations before the next chunk runs, so a chunk bounds the peak.

Estimate = static + per_triplet * chunk:

* static: the scorer's parameter and buffer bytes and its moment pool (exact: real tensors),
  :data:`ENCODE_BYTES` for one slice of the VAE encode (``models/vae.encode_chunked`` holds a
  slice's input pixels at 8 MiB whatever the size and dtype, so its activations take about the
  same bytes at 512 px in bf16 and 1024 px in float32; the peak of a small chunk is the encode's,
  not the UNet's), and :data:`RESERVE_BYTES` for what ``torch.cuda.max_memory_allocated`` does
  not see (the CUDA context, cuBLAS and cuDNN workspaces) and the prompt tables;
* per_triplet: :data:`PER_TRIPLET_BYTES_512` for SD-1.5 at 512 px in bf16, scaled by
  (img_size / 512)^2 (activations are spatial), the scorer's ``hbm_scale`` and, for a scorer
  built with ``dtype=torch.float32``, :data:`FLOAT32_SCALE`;
* :data:`MARGIN` of the budget may be filled; the rest is the caching allocator's slack.

The pair paths (``score_batch`` of the three DiffSim scorers) have no chunk loop: like the JAX
scorers, they refuse an over-budget batch of P pairs outright (:func:`check_pairs`), before
anything of the call reaches the card. A pair is 2 images and 4 CFG forwards against a triplet's
3 and 6, so its tail is 2/3 of a triplet's, plus :data:`PAIR_PIXEL_BYTES` for each value of its
two images (``metrics/scorer_base.to_device_pixels`` uploads all 2P images at once). Under
``torch.distributed`` each rank checks its own share of the rows (``parallel/mesh.shard_rows``).
``chip_smoke.py`` measures the pair tails' slopes on the card and fails unless this estimate
is above each of them.

The budget is the card's total memory (``torch.cuda.mem_get_info``). ``DIFFSIM_TPU_HBM_GB``
overrides it in GB, as in the JAX package; a value <= 0 disables the guard. On a CPU device the
guard is off unless that variable is set.
"""

from __future__ import annotations

import os

import torch

# Each measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power limit, and held
# there above what it measures in the same run. The device memory one SD-1.5 triplet adds to the
# scoring tail (UNet to the tap and readout) at 512 px in bf16: the slope of
# torch.cuda.max_memory_allocated between 8 and 16 triplets, 0.342 GB, rounded up.
PER_TRIPLET_BYTES_512 = 0.4e9
# A float32 scorer's per-triplet bytes over its bf16 constant's. The float32 tails' slopes
# (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W): SD-1.5 0.438 GB a triplet at 512 px against
# a bf16 constant of 0.4 GB (1.10x), SDXL 1.284 GB at 1024 px against 0.8 (1.61x), DiT-XL/2
# 0.3411 GB at 512 px against 0.2 (1.71x: the most, as DiT's bf16 tail is the least float32
# already); 1.71 rounded up with the bf16 constants' margin. 1.5 held SD-1.5 only.
FLOAT32_SCALE = 2.0
# the peak of one VAE encode slice, rounded up: 11.84 GB for SD-1.5's 16 images at 512 px in
# bf16, 7.54 GB for SDXL's 2 images at 1024 px in float32
ENCODE_BYTES = 12.5e9
# the CUDA context, cuBLAS/cuDNN workspaces and the prompt tables, outside the allocator's count
RESERVE_BYTES = 1.0e9
# bytes a pixel value of a pair's images takes on the device while metrics/scorer_base
# to_device_pixels runs, at its peak: the uint8 upload and two float32 maps (u8 / 127.5, then
# - 1) at once; no later step holds more (the scoring-dtype copy beside the upload and one map,
# then the NCHW copy beside that copy)
PAIR_PIXEL_BYTES = 1 + 4 + 4
# the share of the budget an estimate may fill
MARGIN = 0.9


class HbmBudgetError(RuntimeError):
    """A requested scoring chunk or pair batch would exceed the device-memory budget. Raised on
    the host before anything of it runs."""


def budget_bytes(device: torch.device) -> float:
    """The device-memory budget in bytes; <= 0 means the guard is off."""
    env = os.environ.get("DIFFSIM_TPU_HBM_GB")
    if env is not None:
        return float(env) * 1e9
    if device.type == "cuda":
        return float(torch.cuda.mem_get_info(device)[1])
    return 0.0


def module_bytes(*modules: torch.nn.Module) -> int:
    """Parameter and buffer bytes of ``modules``."""
    return sum(t.numel() * t.element_size() for m in modules
               for t in (*m.parameters(), *m.buffers()))


def scorer_static_bytes(scorer) -> float:
    """Batch-independent bytes: the scorer's modules, its moment pool once built, one encode
    slice and the reserve."""
    nets = [m for m in vars(scorer).values() if isinstance(m, torch.nn.Module)]
    static = module_bytes(*nets) + ENCODE_BYTES + RESERVE_BYTES
    cache = getattr(scorer, "_moment_cache", None)
    if cache is not None:
        static += cache.pool.numel() * cache.pool.element_size()
    return static


def per_triplet_bytes(scorer) -> float:
    """Peak bytes one triplet adds to a chunk of the scorer's triplet path."""
    scale = FLOAT32_SCALE if scorer.dtype == torch.float32 else 1.0
    return PER_TRIPLET_BYTES_512 * scorer.hbm_scale * (scorer.img_size / 512.0) ** 2 * scale


def max_triplets(scorer) -> int | None:
    """The largest chunk whose estimate fits the budget; None when the guard is off, 0 when
    nothing fits."""
    budget = budget_bytes(scorer.device)
    if budget <= 0:
        return None
    avail = budget * MARGIN - scorer_static_bytes(scorer)
    return max(0, int(avail // per_triplet_bytes(scorer)))


def check_chunk(scorer, chunk: int) -> None:
    """Refuse an explicit ``chunk`` whose estimate exceeds the budget."""
    budget = budget_bytes(scorer.device)
    if budget <= 0:
        return
    est = scorer_static_bytes(scorer) + per_triplet_bytes(scorer) * chunk
    if est > budget * MARGIN:
        raise HbmBudgetError(
            f"a {chunk}-triplet chunk at {scorer.img_size}px is estimated at {est / 1e9:.2f} GB "
            f"against a {budget / 1e9:.2f} GB device budget ({MARGIN:.0%} usable): pass a "
            f"smaller chunk=, score in smaller batches, or set DIFFSIM_TPU_HBM_GB")


def per_pair_bytes(scorer) -> float:
    """Peak bytes one pair adds to a ``score_batch`` call: 2/3 of a triplet's tail, and its two
    images' pixels as they are uploaded."""
    pixels = 2 * scorer.img_size * scorer.img_size * 3 * PAIR_PIXEL_BYTES
    return per_triplet_bytes(scorer) * (2 / 3) + pixels


def check_pairs(scorer, n_pairs: int) -> None:
    """Refuse a ``score_batch`` call of ``n_pairs`` pairs whose estimate exceeds the budget.
    The pair paths have no chunk loop, so the remedy is a smaller batch."""
    budget = budget_bytes(scorer.device)
    if budget <= 0:
        return
    est = scorer_static_bytes(scorer) + per_pair_bytes(scorer) * n_pairs
    if est > budget * MARGIN:
        raise HbmBudgetError(
            f"a {n_pairs}-pair call at {scorer.img_size}px is estimated at {est / 1e9:.2f} GB "
            f"against a {budget / 1e9:.2f} GB device budget ({MARGIN:.0%} usable): score in "
            f"smaller batches (the 2AFC runner's --batch_size, the service's --batch_size), or "
            f"set DIFFSIM_TPU_HBM_GB if this card has more memory")
