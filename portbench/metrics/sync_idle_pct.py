"""sync_idle_pct: the share of the traced window spent in device-idle gaps of at least 20 us
that begin while the host is inside one of the program's ``diffsim.sync.*`` spans: the device
idle the shared clock puts down to the program's synchronising copies."""

from portbench.harness.spans import idle_share_pct


def read(r):
    return idle_share_pct(r.trace, lambda n: n.startswith("diffsim.sync."))
