"""The comparison that decides ``correct``: a sample, drawn from the seed, of the answers the
window got back, each scored again by the configuration's plain reference
(``reference/<reference>.py``) from the same pixels and the same weights, made again from the
seed. The number compared is the widest gap between a score the program returned and the
reference's score of the same images. Where the cell's limits name ``moment_gap``, the VAE's
moments that the program's moment cache holds for those images are compared too, each image's
widest gap over the largest moment the reference gives it: the VAE's own precision shows there,
where the scores hardly see it."""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness import system
from portbench.harness import weights as weights_mod


def pick(done: list, k: int, rng: np.random.Generator) -> list:
    """``k`` (record, item) picks among the answers that came back, drawn without
    replacement."""
    items = [(i, j) for i, d in enumerate(done) if d.scores is not None
             for j in range(d.ring_idx.shape[1])]
    if not items:
        return []
    sel = rng.choice(len(items), size=min(k, len(items)), replace=False)
    return [(done[items[s][0]], items[s][1]) for s in sorted(sel)]


def reference_answers(ref, picks: list, ring: np.ndarray) -> tuple[list, list]:
    """The reference's scores of each pick ((s_ab, s_ac) of a triplet, (s,) of a pair) and the
    moments it encoded for the pick's images, on the host."""
    scores, moments = [], []
    for rec, j in picks:
        m = ref.moments(ring[rec.ring_idx[:, j]])
        scores.append(ref.scores(m))
        moments.append(m.float().cpu())
    return scores, moments


def _resident(missing):
    raise LookupError(f"{len(missing)} images left the moment cache")


def cached_moments(scorer, picks: list) -> list | None:
    """The moments the program's moment cache holds for each pick's images, on the host (None
    for a pick whose images it no longer holds); None where the calls went past the cache."""
    cache = getattr(scorer, "_moment_cache", None)
    if cache is None or any(rec.keys is None for rec, _ in picks):
        return None
    from diffsim_tpu_torch.runtime.device_cache import image_key

    out = []
    for rec, j in picks:
        keys = [image_key(role[j]) for role in rec.keys]
        if not all(k in cache for k in keys):
            out.append(None)
            continue
        slots = torch.from_numpy(cache.ensure(keys, _resident)).long().to(cache.pool.device)
        out.append(cache.pool.index_select(0, slots).float().cpu())
    return out


def moment_gap(program: list, reference: list) -> float:
    """The widest gap between two sides' moments of an image, over the largest of the
    reference's; an image the program no longer holds counts as failed (inf)."""
    gaps = [float("inf") if p is None else
            float((p - r).abs().flatten(1).amax(1).div(r.abs().flatten(1).amax(1)).max())
            for p, r in zip(program, reference)]
    return max(gaps, default=float("nan"))


def program_scores(picks: list) -> list:
    return [tuple(float(x) for x in rec.scores[:, j]) if rec.scores.ndim == 2 else
            (float(rec.scores[j]),) for rec, j in picks]


def widest_gap(a: list, b: list) -> float:
    return float(max((abs(x - y) for ra, rb in zip(a, b) for x, y in zip(ra, rb)),
                     default=float("nan")))


def reference(config: dict, seed: int, device, precision: str = "float32"):
    """The reference on ``device`` with the run's weights, made again from ``seed``;
    ``precision`` other than float32 makes the control."""
    w = weights_mod.make(config, seed, device)
    ref = system.reference_of(config).Reference(config, w, device, precision)
    del w
    return ref
