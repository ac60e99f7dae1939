"""One run of one cell: set up the system, warm the cell's shapes, measure for ``--seconds``,
check the answers against the reference, print the result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: ``BENCHMARK.json`` names its configuration
(``configs/<config>.json``, which names its system and reference modules) and traffic mix
(``traffic/<mix>.json``, which names its kind's module); ``limits/<cell>.json`` holds its
correctness limit and sample size; each metric is read by ``metrics/<metric>.py``
(``harness/by_name.py``).
With ``--trace 0`` the line holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from ``torch.profiler`` over the window.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

from portbench.harness import by_name, correct, drive, system, traffic, work
from portbench.harness import trace as trace_mod
from portbench.harness import weights as weights_mod

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "diffsim_tpu"}  # top-level module names
HOST_THREADS = 1  # torch's CPU threads: the host path launches kernels, it computes nothing


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(workload: str) -> dict:
    """The cell's entries and files: {bench, cell, config, mix, limits}."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    return {"bench": bench, "cell": cell,
            "config": load_json(HERE, "configs", f"{cell['config']}.json"),
            "mix": traffic.load(HERE, cell["traffic"]),
            "limits": load_json(HERE, "limits", f"{workload}.json")}


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a cell reports: its end-to-end ones, or with ``trace`` its
    per-layer ones (a per-layer metric without ``workloads`` goes to every cell that reports
    the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


def reader(name: str):
    return by_name.module("metrics", name).read


def process_start() -> float:
    """When this process started, on ``time.time``'s clock (Linux's /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(float(x.split()[1]) for x in f if x.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def cache_dirs() -> None:
    """Kernel and compiler caches at fixed paths inside the checkout."""
    base = os.path.join(HERE, "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def counters(scorer):
    from diffsim_tpu_torch.ops import kernels

    cache = getattr(scorer, "_moment_cache", None)
    return {"cache": dict(cache.stats) if cache is not None else None,
            "launches": kernels.launch_counts()}


def prepare(spec: dict, seed: int, seconds: float, device) -> types.SimpleNamespace:
    """Set-up of a run: the kernels, the scorer with the seed's weights, and the cell's traffic
    with the warm-up of its shapes (its kind's ``prepare``). Returns {scorer, ring, loop}:
    ``loop()`` measures one window of ``seconds``."""
    config, mix = spec["config"], spec["mix"]
    sys_mod = system.of(config)
    t = time.time()
    system.build_kernels(device)
    log(f"[setup] kernels {time.time() - t:.1f} s")
    t = time.time()
    scorer = sys_mod.build_scorer(config, device, weights_mod.make(config, seed, device))
    sync(device)
    log(f"[setup] scorer and weights {time.time() - t:.1f} s")
    t = time.time()
    run = types.SimpleNamespace(scorer=scorer, config=config, mix=mix, seed=seed,
                                seconds=seconds, kwargs=sys_mod.score_kwargs(config),
                                device=device)
    s = traffic.kind(mix).prepare(run)
    s.scorer = scorer
    sync(device)
    log(f"[setup] warm-up {time.time() - t:.1f} s")
    return s


def release(s: types.SimpleNamespace, device) -> None:
    """Free the program's state before the reference runs."""
    s.scorer = s.loop = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def sample(spec: dict, seed: int, s: types.SimpleNamespace, w) -> tuple[list, list | None]:
    """The answers compared, drawn from the seed among the window's, and the program's moments
    of their images where the cell's limits compare them; read before the program is freed."""
    picks = correct.pick(w.done, spec["limits"]["sample"], np.random.default_rng([seed, 3]))
    moments = correct.cached_moments(s.scorer, picks) if "moment_gap" in spec["limits"] else None
    return picks, moments


def check(spec: dict, seed: int, w, picks: list, moments, ring, device):
    """({name: {value, limit}} of the numbers compared, the reference's scores and moments of
    the picks), the reference made again from the seed once the program is freed."""
    t = time.time()
    limits = spec["limits"]
    ref = correct.reference(spec["config"], seed, device)
    scores, ref_moments = correct.reference_answers(ref, picks, ring)
    del ref
    log(f"[check] reference over {len(picks)} answers {time.time() - t:.1f} s")
    compared = {"score_gap": {"value": correct.widest_gap(correct.program_scores(picks), scores),
                              "limit": limits["score_gap"]}}
    if "moment_gap" in limits:
        compared["moment_gap"] = {
            "value": float("inf") if moments is None else correct.moment_gap(moments, ref_moments),
            "limit": limits["moment_gap"]}
    compared["failed"] = {"value": w.failed, "limit": 0}
    return compared, scores, ref_moments


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of the cell ``spec`` (``cell_spec``) on ``device``; returns the result line's
    object. ``t_start`` is the process's start on ``time.time``'s clock."""
    seed = int(seed) % 2 ** 64
    config, mix, cell = spec["config"], spec["mix"], spec["cell"]
    s = prepare(spec, seed, seconds, device)
    setup_s = time.time() - t_start

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = counters(s.scorer)
    with trace_mod.Profiler() if trace else contextlib.nullcontext() as prof:
        with drive.span("window"):
            w = s.loop()
    after = counters(s.scorer)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log(f"[window] {w.attempted} attempted, {len(w.done)} back, {w.failed} failed, "
        f"{w.t_end - w.t0:.3f} s")
    if w.rounds:
        log(f"[window] {len(w.rounds)} rounds, mean {statistics.mean(p for p, _ in w.rounds):.3f} "
            f"pairs (largest {max(p for p, _ in w.rounds)}), "
            f"{statistics.mean(ms for _, ms in w.rounds):.3f} ms")
    if w.enqueue_ms:
        log(f"[window] enqueue median {statistics.median(w.enqueue_ms):.3f} ms")
    if w.lateness_ms:
        log(f"[window] generator lateness: median {statistics.median(w.lateness_ms):.3f} ms, "
            f"max {max(w.lateness_ms):.3f} ms over {len(w.lateness_ms)} requests")

    r = types.SimpleNamespace(cell=cell["name"], config=config, mix=mix, seconds=seconds,
                              setup_s=setup_s, window=w, before=before, after=after,
                              memory_peak_bytes=peak, device=device,
                              trace=prof.result() if prof is not None else None)
    r.work = work.of(config) if trace else None
    result_metrics = {}
    for m in metrics_of(spec["bench"], cell["name"], trace):
        value = reader(m["name"])(r)
        if value is not None:
            result_metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    picks, moments = sample(spec, seed, s, w)
    ring = s.ring
    release(s, device)
    compared, _, _ = check(spec, seed, w, picks, moments, ring, device)
    ok = bool(picks) and all(c["value"] <= c["limit"] for c in compared.values())

    out = {"correct": ok, "attempted": w.attempted, "failed": w.failed,
           "metrics": result_metrics,
           "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                      "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
                      else "cpu",
                      "count": cell["chips"], "memory_peak_bytes": int(peak)}}
    if r.trace is not None:
        out["device"]["busy_s"] = r.trace.busy_s()
        out["device"]["window_s"] = r.trace.window_s
        out["breakdown"] = {"device_ops": r.trace.top_ops(), "idle_gaps": r.trace.idle_gaps()}
    out["compared"] = compared
    return out


def card_note() -> None:
    """The card's name and power limit, beside the numbers of this run."""
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        log(f"[card] {q.stdout.strip()}")
    except (OSError, subprocess.TimeoutExpired) as e:
        log(f"[card] nvidia-smi unavailable: {e}")


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    t_start = process_start()
    args = parse(argv)
    spec = cell_spec(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["cell"]["chips"]:
        log(f"needs {spec['cell']['chips']} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    cache_dirs()
    torch.set_num_threads(HOST_THREADS)
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda:0"),
                   t_start)
    card_note()
    bad = forbidden_modules()
    if bad:
        log(f"JAX or the JAX package was loaded in this process: {bad}")
        return 4
    for name, c in out["compared"].items():
        log(f"compared {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0
