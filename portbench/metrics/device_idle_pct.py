"""device_idle_pct: the share of the traced window in which no kernel, copy or fill ran on the
card (``torch.profiler``'s device activities)."""


def read(r):
    if r.trace is None or not r.trace.device:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
