"""A kernel's share of its roofline over a traced window: the least time the H100 could take
for the work the kernel did (``peaks.attention_bound_s`` over the shapes the reference runs),
over the kernel's device time in the trace. The trace's count of the kernel's launches has to
equal the program's launch counter over the window, or the reading is left out."""

from __future__ import annotations

import re

from portbench.harness import peaks


def attention_share(r, kernel: str, wrapper: str, sites, units, admits, elem_bytes: int,
                    tf32_passes: float = 0.0):
    """``kernel``: a regular expression of the kernel's function names; ``wrapper``: its launch
    counter; ``sites``: the (heads, tokens, head dim) of the attentions one unit runs;
    ``units(record)``: the units (UNet rows, encoded images) of a call or request; ``admits``:
    which sites the kernel takes."""
    if r.trace is None or r.work is None:
        return None
    pattern = re.compile(kernel)
    secs, n = r.trace.device_time(lambda name: pattern.search(name) is not None)
    launches = r.after["launches"].get(wrapper, 0) - r.before["launches"].get(wrapper, 0)
    if n == 0 or secs <= 0.0 or n != launches:
        return None
    done = sum(units(d) for d in r.window.done if d.scores is not None)
    per_unit = sum(peaks.attention_bound_s(1, h, s, d, elem_bytes, tf32_passes)
                   for h, s, d in sites if admits(h, s, d))
    return 100.0 * done * per_unit / secs if per_unit > 0 else None
