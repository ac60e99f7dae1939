"""pairs_per_s: pairs scored by the calls dispatched in the window, over the time from the
window's start to the scores of the last of them (host clock)."""


def read(r):
    w = r.window
    pairs = sum(d.pairs for d in w.done if d.scores is not None)
    return pairs / (w.t_end - w.t0) if pairs else None
