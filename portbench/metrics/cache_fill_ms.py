"""cache_fill_ms: the median over the window's calls of the host time inside the call spent in
the program's ``diffsim.cache.fill`` spans (the moment cache's misses: their rows, upload, VAE
launches and scatter); 0 for a call with no miss."""

from portbench.harness.spans import per_call_ms


def read(r):
    return per_call_ms(r.trace, lambda n: n == "diffsim.cache.fill")
