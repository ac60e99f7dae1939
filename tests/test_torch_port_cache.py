"""The port's device moment cache (``diffsim_tpu_torch/runtime/device_cache.py``), its cached
scoring path (``score_triplet_paths``) and its device-memory guard (``runtime/hbm_guard.py``),
on the CPU with the tiny SD-1.5 and SDXL configs in float32.

The LRU cases are those of the JAX package's tests/test_device_cache.py, run on the port's copy.
Cached scores are held to the fresh path within 2e-6 (the miss slabs and the fresh batch encode
different numbers of images at once), and an all-hit rescore to exact equality."""

import numpy as np
import pytest
import torch
from PIL import Image

from diffsim_tpu.runtime.device_cache import DeviceFeatureCache as JaxFeatureCache
from diffsim_tpu_torch.core.image import load_and_process_u8
from diffsim_tpu_torch.metrics.diffsim_sd15 import DiffSimSD15
from diffsim_tpu_torch.metrics.diffsim_xl import DiffSimXL
from diffsim_tpu_torch.metrics.registry import _tiny_configs
from diffsim_tpu_torch.runtime import device_cache, hbm_guard
from diffsim_tpu_torch.runtime.device_cache import DeviceFeatureCache

CACHED_ATOL = 2e-6
ARGS = {"diffsim": dict(prompt="p", target_step=600, similarity="cosine", target_layer=(0,)),
        "diffsim_xl": dict(prompt="p", target_step=900, similarity="cosine",
                           target_layer=(0, 1, 1))}


def _np_cache(capacity, cls=DeviceFeatureCache):
    pool = np.zeros((capacity, 2), np.float32)
    calls = []

    def update(pool, rows, slots):
        calls.append((rows.shape[0], list(slots)))
        out = pool.copy()
        out[slots] = rows
        return out

    return cls(pool, update, capacity), calls


def _rows_for(missing):
    return np.stack([np.full(2, float(sum(map(ord, k)) % 997), np.float32) for k in missing])


@pytest.mark.parametrize("cls", [DeviceFeatureCache, JaxFeatureCache])
def test_ensure_assigns_hits_and_misses(cls):
    """The port's copy and the JAX original keep the same books on the same calls."""
    cache, calls = _np_cache(4, cls)
    slots = cache.ensure(["a", "b", "a"], _rows_for)
    assert slots.shape == (3,) and slots.dtype == np.int32
    assert slots[0] == slots[2] != slots[1]
    assert cache.misses == 2 and cache.hits == 1
    np.testing.assert_array_equal(cache.pool[slots[0]], _rows_for(["a"])[0])
    np.testing.assert_array_equal(cache.pool[slots[1]], _rows_for(["b"])[0])
    n_calls = len(calls)
    assert list(cache.ensure(["b", "a"], _rows_for)) == [slots[1], slots[0]]
    assert len(calls) == n_calls and cache.evictions == 0
    assert cache.stats == {"hits": 3, "misses": 2, "evictions": 0, "resident": 2,
                           "capacity": 4}


def test_lru_evicts_oldest_unpinned():
    cache, _ = _np_cache(3)
    s_abc = cache.ensure(["a", "b", "c"], _rows_for)
    cache.ensure(["a"], _rows_for)  # b is now the least recent
    s_d = cache.ensure(["d"], _rows_for)
    assert cache.evictions == 1 and s_d[0] == s_abc[1]
    assert list(cache.ensure(["a", "c"], _rows_for)) == [s_abc[0], s_abc[2]]
    assert cache.misses == 4


def test_keys_of_current_batch_are_pinned():
    cache, _ = _np_cache(3)
    cache.ensure(["a", "b", "c"], _rows_for)
    slots = cache.ensure(["a", "d", "e"], _rows_for)
    assert cache.ensure(["a"], _rows_for)[0] == slots[0] and cache.misses == 5


def test_batch_larger_than_capacity_raises():
    cache, _ = _np_cache(2)
    with pytest.raises(ValueError, match="unique images"):
        cache.ensure(["a", "b", "c"], _rows_for)


def test_misses_are_encoded_exactly_in_bounded_slabs():
    """67 misses take one 64-image slab and one of 3: no padding rows are encoded."""
    cache, calls = _np_cache(70)
    keys = [f"k{i}" for i in range(67)]
    slots = cache.ensure(keys, _rows_for)
    assert [n for n, _ in calls] == [device_cache.MAX_SLAB, 3]
    assert sorted(s for _, sl in calls for s in sl) == list(range(67))
    for k, s in zip(keys, slots):
        np.testing.assert_array_equal(cache.pool[s], _rows_for([k])[0])


def test_failed_update_rolls_back_its_slab():
    """An update that raises (out of memory on the card) leaves no key pointing at an unwritten
    row: the failing slab's keys miss again on the next call."""
    cache, _ = _np_cache(4)

    def boom(pool, rows, slots):
        raise RuntimeError("out of memory")

    good = cache._update
    cache._update = boom
    with pytest.raises(RuntimeError):
        cache.ensure(["a", "b"], _rows_for)
    assert "a" not in cache and "b" not in cache
    cache._update = good
    cache.ensure(["a", "b"], _rows_for)
    assert cache.stats["resident"] == 2


def _scorer(name, **kw):
    cls = DiffSimSD15 if name == "diffsim" else DiffSimXL
    return cls(img_size=32, device="cpu", **_tiny_configs(name), **kw)


def _image_files(tmp_path, n, size=40):
    rng = np.random.default_rng(1234)
    paths = []
    for i in range(n):
        p = tmp_path / f"img{i}.png"
        Image.fromarray(rng.integers(0, 256, (size, size, 3)).astype(np.uint8)).save(p)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("name", ["diffsim", "diffsim_xl"])
def test_score_triplet_paths_matches_fresh_path(tmp_path, name):
    scorer = _scorer(name)
    paths = _image_files(tmp_path, 5)
    # image 0 is A of both triplets and C of the second: repeated images take one slot each
    pa, pb, pc = [paths[0], paths[0]], [paths[1], paths[2]], [paths[3], paths[0]]
    s_ab, s_ac = scorer.score_triplet_paths(pa, pb, pc, **ARGS[name])
    cache = scorer._moment_cache
    assert cache.stats["resident"] == 4 and cache.misses == 4 and cache.hits == 2
    pix = [np.concatenate([load_and_process_u8(p, 32) for p in role]) for role in (pa, pb, pc)]
    f_ab, f_ac = scorer.score_triplet_batch(*pix, **ARGS[name])
    np.testing.assert_allclose(s_ab, f_ab, atol=CACHED_ATOL)
    np.testing.assert_allclose(s_ac, f_ac, atol=CACHED_ATOL)
    again = scorer.score_triplet_paths(pa, pb, pc, **ARGS[name])
    assert cache.misses == 4 and cache.hits == 8
    np.testing.assert_array_equal(again[0], s_ab)
    np.testing.assert_array_equal(again[1], s_ac)
    # the pool holds the VAE's moments in its output dtype, one row per image
    moments = scorer._encode([pix[0][:1]])[0, 0]
    slot = cache._slot_of[device_cache.image_key(paths[0])]
    np.testing.assert_allclose(cache.pool[slot].numpy(), moments.numpy(), atol=1e-6)


def test_cached_path_takes_decoded_rows_and_loader(tmp_path):
    """Misses fill from the caller's decoded rows, else from the threaded loader; both give the
    scores that decoding from disk gives."""
    from diffsim_tpu_torch.core.image import ImageLoader, process_image_u8

    paths = _image_files(tmp_path, 3)
    roles = [paths[0]], [paths[1]], [paths[2]]
    ref = _scorer("diffsim").score_triplet_paths(*roles, **ARGS["diffsim"])
    pix = [load_and_process_u8(p[0], 32) for p in roles]
    rows = _scorer("diffsim").score_triplet_paths(*roles, *pix, **ARGS["diffsim"])
    loader = ImageLoader(32, preprocess=lambda im: process_image_u8(im, 32))
    try:
        loaded = _scorer("diffsim").score_triplet_paths(*roles, loader=loader,
                                                        **ARGS["diffsim"])
    finally:
        loader.close()
    for out in (rows, loaded):
        np.testing.assert_array_equal(out[0], ref[0])
        np.testing.assert_array_equal(out[1], ref[1])
    with pytest.raises(TypeError, match="uint8"):
        _scorer("diffsim").score_triplet_paths(*roles, *(p.astype(np.float32) for p in pix))


@pytest.mark.parametrize("budget_mb, cap", [(None, 16384), (0.1, 128), (2.0, 244)])
def test_moment_pool_capacity(monkeypatch, budget_mb, cap):
    """cap = clamp(budget / row bytes, 128, 16384); a tiny-config row is 16 x 16 x 8 float32 =
    8192 bytes, so the default 512 MB clamps to 16384."""
    if budget_mb is not None:
        monkeypatch.setenv("DIFFSIM_TPU_MOMENT_CACHE_MB", str(budget_mb))
    scorer = _scorer("diffsim")
    cache = scorer._ensure_moment_cache()
    assert cache.capacity == cap and tuple(cache.pool.shape) == (cap, 8, 16, 16)
    assert cache.pool.dtype == torch.float32 and cache.pool.device.type == "cpu"


def test_guard_is_off_on_the_cpu_without_a_budget(monkeypatch):
    monkeypatch.delenv("DIFFSIM_TPU_HBM_GB", raising=False)
    scorer = _scorer("diffsim")
    assert hbm_guard.max_triplets(scorer) is None
    assert device_cache.resolve_cached_chunk(1000, None, scorer) == 1000


@pytest.mark.parametrize("name", ["diffsim", "diffsim_xl"])
def test_guard_auto_chunks_and_refuses(monkeypatch, name):
    """Under a budget that holds three triplets the guard chunks a larger call into threes, with
    the scores of the unchunked call, and refuses an explicit chunk of four."""
    scorer = _scorer(name)
    per = hbm_guard.per_triplet_bytes(scorer)
    static = hbm_guard.scorer_static_bytes(scorer)
    monkeypatch.setenv("DIFFSIM_TPU_HBM_GB", str((static + 3.5 * per) / hbm_guard.MARGIN / 1e9))
    assert hbm_guard.max_triplets(scorer) == 3
    assert device_cache.resolve_cached_chunk(7, None, scorer) == 3
    assert device_cache.resolve_cached_chunk(2, None, scorer) == 2
    with pytest.raises(hbm_guard.HbmBudgetError, match="4-triplet"):
        device_cache.resolve_cached_chunk(7, 4, scorer)
    rng = np.random.default_rng(5)
    pix = [rng.integers(0, 256, (5, 32, 32, 3), dtype=np.uint8) for _ in range(3)]
    chunked = scorer.score_triplet_batch(*pix, **ARGS[name])
    monkeypatch.setenv("DIFFSIM_TPU_HBM_GB", "0")  # <= 0: the guard is off
    whole = scorer.score_triplet_batch(*pix, **ARGS[name])
    for a, b in zip(chunked, whole):
        np.testing.assert_allclose(a, b, atol=CACHED_ATOL)
    monkeypatch.setenv("DIFFSIM_TPU_HBM_GB", str(static / 2 / 1e9))
    with pytest.raises(hbm_guard.HbmBudgetError, match="not even one"):
        scorer.score_triplet_batch(*pix, **ARGS[name])


def test_guard_counts_the_pool(monkeypatch):
    """The moment pool is static memory: building it lowers the chunk the guard allows."""
    scorer = _scorer("diffsim")
    before = hbm_guard.scorer_static_bytes(scorer)
    pool = scorer._ensure_moment_cache().pool
    assert hbm_guard.scorer_static_bytes(scorer) == before + pool.numel() * pool.element_size()
    assert before == (hbm_guard.module_bytes(scorer.unet, scorer.vae, scorer.text)
                      + hbm_guard.ENCODE_BYTES + hbm_guard.RESERVE_BYTES)
