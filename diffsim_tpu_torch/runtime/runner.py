"""Batched 2AFC benchmark executor (the port's copy of ``diffsim_tpu/runtime/runner.py``).

Planning (``data/benchmarks.py``) is separate from scoring, so the executor batches the two
pairs of every comparison across the whole benchmark, decodes images on host threads while the
card scores the previous batch, logs every comparison to JSONL (resumable), and reproduces each
reference script's accuracy arithmetic: TID2013 and DreamBench++ compare with ``>`` whatever the
similarity, CUTE / Sref / IPref flip for mse, NIGHTS and DreamBench++ compare against human
votes. The ensemble vote (``run_2afc_ensemble``) waits for the baseline metrics.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Sequence

import numpy as np

from diffsim_tpu_torch.core.image import ImageLoader, process_image_u8
from diffsim_tpu_torch.data.benchmarks import Comparison
from diffsim_tpu_torch.runtime.profiling import StageTimer
from diffsim_tpu_torch.runtime.results import ResultLog

# decision rules (which protocol uses which arithmetic)
STANDARD = "standard"  # b wins, direction flips for lower-better metrics; tracks 2x accuracy
ALWAYS_GREATER = "always_greater"  # TID2013: s_ab > s_ac whatever the similarity
VOTE = "vote"  # NIGHTS: predicted (direction-aware) == vote
VOTE_GREATER = "vote_greater"  # DreamBench++: predicted = 0 if s_ab > s_ac else 1; == vote
PREFETCH = 2  # batches decoded ahead of the one being scored


@dataclasses.dataclass
class Report:
    total: int = 0
    correct: int = 0
    correct_2x: int = 0

    @property
    def accuracy(self) -> float:
        return self.correct / self.total * 100 if self.total else 0.0

    @property
    def accuracy_2x(self) -> float:
        return self.correct_2x / self.total * 100 if self.total else 0.0


def judge(rule: str, s_ab: float, s_ac: float, vote, lower_better: bool) -> tuple[bool, bool]:
    """(correct, correct_2x) for one comparison."""
    if rule == STANDARD:
        if lower_better:
            return s_ab < s_ac, s_ab * 2 < s_ac
        return s_ab > s_ac, s_ab > 2 * s_ac
    if rule == ALWAYS_GREATER:
        return s_ab > s_ac, False
    if rule == VOTE:
        predicted = int(s_ab < s_ac) if lower_better else int(s_ab > s_ac)
        return predicted == vote, False
    if rule == VOTE_GREATER:
        predicted = 0 if s_ab > s_ac else 1
        return predicted == vote, False
    raise ValueError(f"unknown decision rule: {rule}")


def run_2afc(
    comparisons: Sequence[Comparison],
    score_pairs: Callable[[np.ndarray, np.ndarray, list[str]], np.ndarray],
    *,
    score_triplets: Callable | None = None,
    score_triplet_paths: Callable | None = None,
    prewarm: Callable | None = None,
    rule: str = STANDARD,
    lower_better: bool = False,
    img_size: int = 512,
    batch: int = 16,
    out_path: str | None = None,
    log_every: int = 450,
    loader: ImageLoader | None = None,
    print_fn=print,
    timer: StageTimer | None = None,
) -> Report:
    """Score all comparisons and report accuracy.

    ``score_pairs(pix_a, pix_b, prompts, blocking=False)`` is the metric adapter's pair path;
    each batch of B comparisons is one 2B-pair call ([(a, b)..., (a, c)...]) unless the adapter
    has the fused triplet path ``score_triplets``. ``score_triplet_paths`` takes priority when
    every input is a path on disk: images are keyed by path in the device moment cache, the
    runner decodes nothing itself (the adapter decodes only cache misses, through ``loader``),
    and ``prewarm`` decodes the next batch's misses while this one scores. One scored batch
    stays in flight: its scores are fetched after the next batch is dispatched."""
    log = ResultLog(out_path)
    report = Report()
    pending = [i for i in range(len(comparisons)) if i not in log.done]
    chunks = [pending[i:i + batch] for i in range(0, len(pending), batch)]
    use_paths = score_triplet_paths is not None and all(
        isinstance(getattr(comparisons[i], r), (str, os.PathLike)) for i in pending for r in "abc")
    if loader is None:
        # the moment cache takes uint8 pixels
        loader = ImageLoader(img_size, preprocess=(lambda im: process_image_u8(im, img_size))
                             if use_paths else None)

    def decode(chunk):
        if use_paths:
            return None  # the adapter decodes the cache misses itself
        return [tuple(loader.submit(getattr(comparisons[i], r)) for r in "abc") for i in chunk]

    inflight = []
    ci = 0
    while ci < len(chunks) and len(inflight) < PREFETCH:
        inflight.append((chunks[ci], decode(chunks[ci])))
        ci += 1

    timer = timer or StageTimer()
    pending_fetch = None  # (chunk, fetch): one scored batch kept in flight

    def drain():
        nonlocal pending_fetch
        if pending_fetch is None:
            return
        chunk_, fetch_ = pending_fetch
        pending_fetch = None
        with timer.stage("fetch"):
            scores = fetch_() if callable(fetch_) else fetch_
        with timer.stage("log"):
            if isinstance(scores, tuple):  # triplet paths: (s_ab, s_ac)
                s_ab, s_ac = scores
            else:
                s_ab, s_ac = scores[:len(chunk_)], scores[len(chunk_):]
            for j, i in enumerate(chunk_):
                log.record(i, s_ab=float(s_ab[j]), s_ac=float(s_ac[j]))

    while inflight:
        chunk, futs = inflight.pop(0)
        with timer.stage("decode"):
            arrs = None if futs is None else [tuple(f.result() for f in e) for e in futs]
        if ci < len(chunks):
            inflight.append((chunks[ci], decode(chunks[ci])))
            ci += 1
        prompts = [comparisons[i].prompt for i in chunk]
        with timer.stage("dispatch"):
            if use_paths:
                roles = [[getattr(comparisons[i], r) for i in chunk] for r in "abc"]
                result = score_triplet_paths(*roles, None, None, None, prompts,
                                             blocking=False, loader=loader)
                if prewarm is not None and inflight:
                    nxt = inflight[0][0]
                    prewarm([[getattr(comparisons[i], r) for i in nxt] for r in "abc"], loader)
            else:
                pa, pb, pc = (np.concatenate([e[j] for e in arrs], axis=0) for j in range(3))
                if score_triplets is not None:
                    result = score_triplets(pa, pb, pc, prompts, blocking=False)
                else:
                    result = score_pairs(np.concatenate([pa, pa], axis=0),
                                         np.concatenate([pb, pc], axis=0), prompts * 2,
                                         blocking=False)
        drain()
        pending_fetch = (chunk, result)
    drain()

    for i in range(len(comparisons)):
        rec = log.done.get(i)
        if rec is None:
            continue
        ok, ok2 = judge(rule, rec["s_ab"], rec["s_ac"], comparisons[i].vote, lower_better)
        report.total += 1
        report.correct += int(ok)
        report.correct_2x += int(ok2)
        if log_every and report.total % log_every == 0:
            print_fn(f"Current total samples: {report.total}")
            print_fn(f"Total {report.total}; Correct {report.correct}; "
                     f"Correct 2x {report.correct_2x}")
            print_fn(f"Accuracy: {report.accuracy}%")

    log.close()
    print_fn(f"Total comparisons: {report.total}")
    print_fn(f"Total {report.total}; Correct {report.correct}; Correct 2x {report.correct_2x}")
    print_fn(f"Accuracy: {report.accuracy}%")
    if rule == STANDARD:
        print_fn(f"2x Accuracy: {report.accuracy_2x}%")
    return report
