"""``triplet_reuse``: a closed loop of calls of ``triplets`` 2AFC triplets of image keys through
the scorer's moment cache (``score_triplet_paths`` with a ``row_map`` of the new keys), ``depth``
dispatched ahead. Of a call's 3T image slots a fixed share (``new_share``, rounded call by call
so that the running count stays at the share) are new images; every other slot draws uniformly
from the images seen so far, as a 2AFC protocol references each image about ten times
(``bench.py``'s ``ReuseWorkload``). ``warm_calls`` calls of their own warm the shapes."""

from __future__ import annotations

import numpy as np

from portbench.harness import drive
from portbench.harness.traffic import TripletCall, share_count


class Stream:
    def __init__(self, mix: dict, ring: np.ndarray, rng: np.random.Generator, prefix: str):
        self.T, self.share = mix["triplets"], mix["new_share"]
        self.ring, self.rng, self.prefix = ring, rng, prefix
        self.pool: list[str] = []
        self.ring_of: dict[str, int] = {}
        self.calls = 0

    def next(self) -> TripletCall:
        slots = 3 * self.T
        k = share_count(self.calls, self.share * slots)
        new_pos = set(self.rng.choice(slots, size=k, replace=False).tolist())
        if not self.pool and 0 not in new_pos:  # the first slot of a run has nothing to reuse
            new_pos.discard(max(new_pos))
            new_pos.add(0)
        flat, row_map = [], {}
        for s in range(slots):
            if s in new_pos:
                key = f"{self.prefix}/u{len(self.ring_of)}.png"
                self.ring_of[key] = len(self.ring_of) % len(self.ring)
                self.pool.append(key)
                row_map[key] = self.ring[self.ring_of[key]]
            else:
                key = self.pool[int(self.rng.integers(len(self.pool)))]
            flat.append(key)
        self.calls += 1
        paths = [flat[r * self.T:(r + 1) * self.T] for r in range(3)]
        idx = np.asarray([[self.ring_of[p] for p in role] for role in paths])
        return TripletCall(idx, paths, row_map, k)


def prepare(run):
    def call(ring, c):
        return run.scorer.score_triplet_paths(*c.paths, row_map=c.row_map, blocking=False,
                                              **run.kwargs)
    return drive.closed(run, Stream, call)
