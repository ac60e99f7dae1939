"""cache_hit_pct: the moment cache's hits over its lookups in the window
(``DeviceFeatureCache.stats`` of ``runtime/device_cache.py``, read before and after)."""


def read(r):
    b, a = r.before["cache"], r.after["cache"]
    if b is None or a is None:
        return None
    hits, misses = a["hits"] - b["hits"], a["misses"] - b["misses"]
    return 100.0 * hits / (hits + misses) if hits + misses else None
