"""The loops that drive the system: a closed loop of triplet calls with a fixed number
dispatched ahead, and an open loop of pair requests into the service's batcher.

Times are ``time.perf_counter`` seconds. Each completed call or request keeps what the
comparison needs: the ring images it scored and the scores it got back.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import threading
import time
import types

import numpy as np
import torch

from portbench.harness import traffic

clock = time.perf_counter


def span(name: str):
    """A named host span in the profiler's trace (no cost when no profiler runs)."""
    return torch.profiler.record_function(f"portbench.{name}")


@dataclasses.dataclass
class Done:
    ring_idx: np.ndarray  # (3, T) triplets or (2, P) pairs
    scores: np.ndarray | None  # (2, T) [s_ab, s_ac] or (P,); None if it failed
    images: int  # images the call encoded (cache misses, or fresh pixels)
    rows: int  # UNet rows (2 per image scored: CFG's uncond and cond)
    pairs: int  # pairs scored: 2 per triplet, 1 per pair
    t_done: float = 0.0
    latency_ms: float = 0.0  # open loop: from due to scores back
    error: str | None = None
    keys: list | None = None  # the call's three role lists of image keys (moment-cache calls)


@dataclasses.dataclass
class Window:
    t0: float
    t_end: float
    done: list
    attempted: int
    enqueue_ms: list = dataclasses.field(default_factory=list)
    rounds: list = dataclasses.field(default_factory=list)  # (pairs, ms) per batcher round
    lateness_ms: list = dataclasses.field(default_factory=list)

    @property
    def failed(self) -> int:
        return sum(d.scores is None for d in self.done) + self.attempted - len(self.done)


def closed_loop(call, stream, seconds: float, depth: int, calls: int | None = None) -> Window:
    """Dispatch calls for ``seconds`` (or ``calls`` of them), ``depth`` in flight: after each
    dispatch that fills the queue the oldest is fetched. The window closes when the last call
    dispatched in it has its scores."""
    pending = collections.deque()
    w = Window(clock(), 0.0, [], 0)

    def finish():
        c, fetch, error = pending.popleft()
        rec = Done(c.ring_idx, None, c.new, 6 * c.triplets, 2 * c.triplets, error=error,
                   keys=c.paths)
        try:
            with span("fetch"):
                rec.scores = np.stack(fetch()) if fetch is not None else None
        except Exception as e:  # a failed call counts against the run, and the loop goes on
            rec.error = f"{type(e).__name__}: {e}"
        rec.t_done = clock()
        w.done.append(rec)

    while clock() - w.t0 < seconds and (calls is None or w.attempted < calls):
        with span("traffic"):
            c = stream.next()
        t = clock()
        fetch = error = None
        try:
            with span("dispatch"):
                fetch = call(c)
        except Exception as e:
            error = f"{type(e).__name__}: {e}"
        w.enqueue_ms.append((clock() - t) * 1e3)
        w.attempted += 1
        pending.append((c, fetch, error))
        if len(pending) >= depth:
            finish()
    while pending:
        finish()
    w.t_end = w.done[-1].t_done if w.done else clock()
    return w


def closed(run, stream_cls, call) -> types.SimpleNamespace:
    """Set-up of a closed-loop kind: the ring and streams of ``stream_cls`` from the run's
    seed, the mix's ``warm_calls`` calls, and {ring, loop}: ``loop()`` drives the window's
    stream for the run's seconds. ``call(ring, c)`` dispatches call ``c`` and returns its
    fetch."""
    mix = run.mix
    ring, warm, stream = traffic.streams(stream_cls, mix, run.config["img_size"], run.seed)
    closed_loop(lambda c: call(ring, c), warm, float("inf"), mix["depth"],
                calls=mix["warm_calls"])
    return types.SimpleNamespace(
        ring=ring, loop=lambda: closed_loop(lambda c: call(ring, c), stream, run.seconds,
                                            mix["depth"]))


def pair_scorer(scorer, kwargs: dict, rounds: list):
    """The service's ``score_pairs`` for ``scorer.score_batch``, as the registry's adapter
    builds it, timing each round (pairs, ms) into ``rounds``."""
    def score_pairs(pa, pb, prompts):
        t = clock()
        out = scorer.score_batch(pa, pb, blocking=True, **{**kwargs, "prompt": prompts})
        rounds.append((len(prompts), (clock() - t) * 1e3))
        return out
    return score_pairs


def open_loop(batcher_cls, work_cls, score_pairs, rounds: list, schedule: list, ring, prompt,
              mix: dict, device, seconds: float) -> Window:
    """Send ``schedule``'s requests to a fresh batcher at their due times, each from a client
    thread of its own that waits for its scores, and wait for all of them (at most a minute past
    the window). A request's latency runs from when it was due."""
    batcher = batcher_cls(score_pairs, mix["max_batch"], mix["max_wait_ms"], device=device)
    w = Window(clock(), 0.0, [], len(schedule), rounds=rounds)
    lock = threading.Lock()  # w.done is appended to from the client threads

    def client(req, t_due):
        rec = Done(req.ring_idx, None, 2 * req.pairs, 4 * req.pairs, req.pairs)
        try:
            work = batcher.submit(work_cls(ring[req.ring_idx[0]], ring[req.ring_idx[1]],
                                           [prompt] * req.pairs))
            rec.scores = np.asarray(work.scores, np.float32)
        except Exception as e:
            rec.error = f"{type(e).__name__}: {e}"
        rec.t_done = clock()
        rec.latency_ms = (rec.t_done - t_due) * 1e3
        with lock:
            w.done.append(rec)

    # a thread a request, so that no request waits for another to enter the batcher's queue
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=max(1, len(schedule)))
    try:
        futs = []
        w.t0 = clock()
        for req in schedule:
            t_due = w.t0 + req.due
            while (left := t_due - clock()) > 0:
                time.sleep(min(left, 0.002) if left < 0.004 else left - 0.002)
            futs.append(pool.submit(client, req, t_due))
            w.lateness_ms.append((clock() - t_due) * 1e3)
        deadline = w.t0 + seconds + 60.0
        for f in futs:
            try:  # a request still out a minute past the window never came: it counts as failed
                f.result(timeout=max(0.0, deadline - clock()))
            except concurrent.futures.TimeoutError:
                pass
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        batcher.close()
    w.t_end = max((d.t_done for d in w.done), default=clock())
    return w
