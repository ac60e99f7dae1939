"""Device-resident feature cache keyed by image identity (the port's counterpart of
``diffsim_tpu/runtime/device_cache.py``).

Every 2AFC protocol reuses its images heavily (CUTE draws ten experiments per class from the
same directories; NIGHTS and TID2013 reuse their reference images), yet a fresh scoring call
decodes, uploads and VAE-encodes every image of every comparison. This cache does that once per
unique image: its VAE moments go into a slot of a pool on the card, and the scoring path
gathers ``pool[slots]``, so a repeated image costs no decode, no upload and no encode.

* The pool is one (capacity, 2C, h, w) tensor on the scorer's device, updated in place with
  ``index_copy_``. PyTorch runs a stream's work in order, so a scoring batch enqueued before an
  update reads the rows as they were.
* Misses are encoded exactly, in slabs of at most :data:`MAX_SLAB` images.
* The host bookkeeping is an LRU over slot numbers; the keys a batch references are pinned
  (made most recent, never evicted by that batch).
"""

from __future__ import annotations

import collections
import os
from typing import Callable, Hashable, Sequence

import numpy as np
import torch

from diffsim_tpu_torch.runtime.profiling import span

MAX_SLAB = 64  # images per miss slab: bounds the encoder's activations
DEFAULT_BUDGET_MB = 512.0  # holds ~8000 unique images of SD-1.5 moments at 512 px in bf16


class DeviceFeatureCache:
    """LRU key -> slot cache over a device-resident feature pool.

    ``update(pool, rows_u8, slots) -> pool`` turns host rows (uint8 pixels) into cached features
    (VAE moments) and writes them into ``pool`` at ``slots``. ``pool`` is the initial
    (capacity, ...) tensor."""

    def __init__(self, pool, update: Callable, capacity: int):
        self.pool = pool
        self._update = update
        self.capacity = int(capacity)
        self._slot_of: collections.OrderedDict[Hashable, int] = collections.OrderedDict()
        self._free = list(range(self.capacity - 1, -1, -1))  # pop() yields slot 0 first
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def ensure(self, keys: Sequence[Hashable],
               rows_for: Callable[[list], np.ndarray]) -> np.ndarray:
        """Make every key resident; return its slot per key, (len(keys),) int32.

        ``rows_for(missing_keys) -> (k, ...)`` gives the host rows of the keys not cached yet,
        in order."""
        pinned = set(keys)
        if len(pinned) > self.capacity:
            raise ValueError(
                f"batch references {len(pinned)} unique images but the device cache holds "
                f"{self.capacity} slots: raise the cache budget or shrink the batch")
        missing: list = []
        seen_missing = set()
        for k in keys:
            if k in self._slot_of:
                self._slot_of.move_to_end(k)  # pin: most recent, not evicted by this call
            elif k not in seen_missing:
                seen_missing.add(k)
                missing.append(k)
        self.hits += len(keys) - len(seen_missing)
        self.misses += len(missing)
        if missing:
            with span("cache.fill"):
                # decode before any slot is assigned: if rows_for fails (an unreadable image),
                # no key may point at an unwritten row
                rows = np.ascontiguousarray(rows_for(missing))
                if rows.shape[0] != len(missing):
                    raise ValueError(
                        f"rows_for returned {rows.shape[0]} rows for {len(missing)} missing keys")
                self._scatter(missing, rows, pinned)
        return np.asarray([self._slot_of[k] for k in keys], np.int32)

    def _assign(self, key: Hashable, pinned: set) -> int:
        if self._free:
            slot = self._free.pop()
        else:
            victim = next(k for k in self._slot_of if k not in pinned)
            slot = self._slot_of.pop(victim)
            self.evictions += 1
        self._slot_of[key] = slot
        return slot

    def _scatter(self, keys: list, rows: np.ndarray, pinned: set):
        """Assign slots and write the rows slab by slab. A slab's keys are registered with its
        write: if an update raises (out of memory), that slab's keys are rolled back and the
        slabs already written stay valid, so no key maps to an unwritten row."""
        n = rows.shape[0]
        start = 0
        while start < n:
            k = min(n - start, MAX_SLAB)
            slab_keys = keys[start:start + k]
            slots = [self._assign(key, pinned) for key in slab_keys]
            try:
                self.pool = self._update(self.pool, rows[start:start + k],
                                         np.asarray(slots, np.int32))
            except BaseException:
                for key, slot in zip(slab_keys, slots):
                    del self._slot_of[key]
                    self._free.append(slot)
                raise
            start += k

    def __contains__(self, key: Hashable) -> bool:
        return key in self._slot_of

    @property
    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses, "evictions": self.evictions,
                "resident": len(self._slot_of), "capacity": self.capacity}


def make_moment_cache(scorer, enc_dtype: torch.dtype) -> DeviceFeatureCache:
    """The VAE-moment pool of a scorer (SD-1.5 or SDXL, which differ in the encode dtype).
    Reads ``scorer.{vae, vae_cfg, img_size, device, moment_cache_mb}``. The pool is allocated on
    the scorer's device in the encoder's output dtype; its capacity is the budget
    (``moment_cache_mb``, else ``$DIFFSIM_TPU_MOMENT_CACHE_MB``, else 512 MB) over a row's bytes,
    clamped to [128, 16384]. An update maps uint8 pixels to [-1, 1] on the device, encodes them
    in the VAE's slices and writes the moments at their slots."""
    from diffsim_tpu_torch.models.vae import encode_chunked

    cfg = scorer.vae_cfg
    h = w = scorer.img_size // cfg.downscale
    c2 = 2 * cfg.latent_channels
    budget_mb = scorer.moment_cache_mb or float(
        os.environ.get("DIFFSIM_TPU_MOMENT_CACHE_MB", DEFAULT_BUDGET_MB))
    row_bytes = h * w * c2 * torch.empty((), dtype=enc_dtype).element_size()
    cap = int(max(128, min(16384, budget_mb * 1e6 // row_bytes)))
    device, vae = scorer.device, scorer.vae  # not the scorer: its cache must not hold it
    pool = torch.zeros((cap, c2, h, w), dtype=enc_dtype, device=device)

    def update(pool, rows_u8, slots):
        with torch.inference_mode():
            with span("sync.cache_pixels"):
                x = torch.from_numpy(rows_u8).to(device)
            x = (x.float() / 127.5 - 1.0).to(enc_dtype).permute(0, 3, 1, 2).contiguous()
            m = encode_chunked(vae, x)
            with span("sync.cache_slots"):
                index = torch.from_numpy(slots).long().to(device)
            pool.index_copy_(0, index, m.to(pool.dtype))
        return pool

    return DeviceFeatureCache(pool, update, cap)


def resolve_cached_chunk(t: int, chunk: int | None, scorer=None) -> int:
    """Triplets per chunk for a triplet dispatch of ``t`` triplets (fresh and cached paths of
    both scorers). With ``scorer``, the device-memory guard (``runtime/hbm_guard.py``) refuses
    an explicit ``chunk`` that does not fit and, when ``chunk`` is None, caps the chunk at the
    largest that fits; it raises when not even one triplet fits."""
    from diffsim_tpu_torch.runtime import hbm_guard

    with span("guard"):
        safe = hbm_guard.max_triplets(scorer) if scorer is not None else None
        if safe is not None and safe < 1:
            raise hbm_guard.HbmBudgetError(
                f"not even one triplet at {scorer.img_size}px fits the device budget "
                f"({hbm_guard.budget_bytes(scorer.device) / 1e9:.2f} GB): lower img_size or "
                "the moment cache budget, or set DIFFSIM_TPU_HBM_GB")
        if chunk is None:
            return min(t, safe) if safe is not None else t
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if scorer is not None:
            hbm_guard.check_chunk(scorer, chunk)
        return chunk


def image_key(path) -> tuple:
    """Cache key of an image path: (fspath, st_mtime_ns, st_size), so that a file rewritten in
    place is encoded again. A path that cannot be stat'ed (a synthetic key in the tests) gives
    (fspath, 0, 0). ``key[0]`` is always the fspath."""
    p = os.fspath(path)
    try:
        st = os.stat(p)
        return (p, st.st_mtime_ns, st.st_size)
    except OSError:
        return (p, 0, 0)


def prewarm_missing(cache: DeviceFeatureCache, paths_roles, loader) -> int:
    """Start threaded decodes of the paths not resident yet and drop the futures: the loader's
    LRU keeps the arrays, so the later miss fill finds them decoded. The 2AFC runner calls it
    for the next chunk while the current one scores. Returns the number submitted."""
    seen = set()
    n = 0
    for role in paths_roles:
        for p in role:
            k = image_key(p)
            if k in seen or k in cache:
                continue
            seen.add(k)
            loader.submit(k[0])
            n += 1
    return n


def ensure_image_slots(cache: DeviceFeatureCache, paths_roles, pix_roles, loader,
                       load_fn, row_map: dict | None = None) -> np.ndarray:
    """The host half of every scorer's ``score_triplet_paths``: the three role path lists ->
    cache slots, (T, 3) int32 [a, b, c] per triplet. Misses are filled, in order of preference,
    from the caller's decoded uint8 role arrays ``pix_roles``, a ``row_map`` {path: (H, W, 3)
    uint8}, the threaded ``loader``, or ``load_fn(path) -> (1, H, W, 3) uint8``."""
    t = len(paths_roles[0])
    keys = [image_key(p) for role in paths_roles for p in role]

    rowsrc: dict = {}
    for role_paths, role_pix in zip(paths_roles, pix_roles):
        if role_pix is None:
            continue
        if role_pix.dtype != np.uint8:
            raise TypeError(f"the moment cache takes uint8 pixels (process_image_u8), got "
                            f"{role_pix.dtype}")
        for i, p in enumerate(role_paths):
            rowsrc.setdefault(os.fspath(p), (role_pix, i))

    def rows_for(missing):
        rows = []
        for key in missing:
            k = key[0]
            hit = rowsrc.get(k)
            if hit is not None:
                rows.append(hit[0][hit[1]])
            elif row_map is not None and k in row_map:
                rows.append(row_map[k])
            elif loader is not None:
                rows.append(loader.submit(k))
            else:
                rows.append(load_fn(k)[0])
        # the loader's futures are read after all of them are submitted
        rows = [r.result()[0] if hasattr(r, "result") else r for r in rows]
        out = np.stack(rows)
        if out.dtype != np.uint8:
            raise TypeError(f"moment-cache rows must be uint8 pixels (got {out.dtype}): pass a "
                            "loader built with process_image_u8")
        return out

    slots = cache.ensure(keys, rows_for)
    return slots.reshape(3, t).T
