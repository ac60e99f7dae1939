"""host_sync_ms: the median over the window's calls of the host time inside the call spent in
the program's ``diffsim.sync.*`` spans: what a ``blocking=False`` call waits for the device
(pageable host-to-device copies, ``mem_get_info``)."""

from portbench.harness.spans import per_call_ms


def read(r):
    return per_call_ms(r.trace, lambda n: n.startswith("diffsim.sync."))
