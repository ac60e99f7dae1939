"""Benchmark CLI of the port: ``python -m diffsim_tpu_torch.cli.main <benchmark> [flags]``
(counterpart of ``diffsim_tpu/cli/main.py``).

One executable for the reference's six 2AFC scripts (CUTE, Sref / InstantStyle, NIGHTS,
TID2013, IPref, DreamBench++) with the same flags, decision arithmetic and printout, batched on
the card. For example, CUTE with the reference's settings:

    python -m diffsim_tpu_torch.cli.main cute --preset cute --image_path DIR
"""

from __future__ import annotations

import contextlib
import sys

from diffsim_tpu_torch.cli.args import arg_parse
from diffsim_tpu_torch.core.image import ImageLoader
from diffsim_tpu_torch.data import benchmarks
from diffsim_tpu_torch.metrics.registry import build_metric
from diffsim_tpu_torch.runtime import runner
from diffsim_tpu_torch.runtime.profiling import StageTimer, trace

BENCHMARKS = {
    # name -> (planner(args) -> comparisons, decision rule)
    "cute": (lambda a: benchmarks.cute(a.image_path, a.seed), runner.STANDARD),
    "style": (lambda a: benchmarks.style(a.image_path, a.seed, a.prompt), runner.STANDARD),
    "sref": (lambda a: benchmarks.style(a.image_path, a.seed, a.prompt), runner.STANDARD),
    "instantstyle": (lambda a: benchmarks.style(a.image_path, a.seed, a.prompt), runner.STANDARD),
    "night": (lambda a: benchmarks.nights(a.image_path, a.seed), runner.VOTE),
    "nights": (lambda a: benchmarks.nights(a.image_path, a.seed), runner.VOTE),
    "tid": (lambda a: benchmarks.tid2013(a.image_path, a.seed), runner.ALWAYS_GREATER),
    "ipref": (lambda a: benchmarks.ipref(a.image_path, a.original_path, a.seed),
              runner.STANDARD),
    "dreambench": (lambda a: benchmarks.dreambench(a.image_path, a.seed, a.prompt),
                   runner.VOTE_GREATER),
}


def run_benchmark(benchmark: str, argv=None, *, device=None):
    """Plan ``benchmark`` from the flags ``argv`` and score it; returns (report, adapter).
    ``device`` is the scoring device (None: the card; the CPU tests pass "cpu")."""
    args = arg_parse(argv)
    if args.num_devices not in (None, 1):
        raise NotImplementedError("--num_devices > 1: multi-GPU scoring is not ported to "
                                  "PyTorch yet (ROADMAP.md, Queue 1 item 10)")
    planner, rule = BENCHMARKS[benchmark]
    comparisons = planner(args)
    if args.shard:
        # host i of N runs comparisons i, i+N, ...: every host plans the same seeded list
        i, n = (int(x) for x in args.shard.split("/"))
        if not 0 <= i < n:
            raise ValueError(f"--shard {args.shard}: need 0 <= I < N")
        comparisons = comparisons[i::n]
        if args.results:
            args.results = f"{args.results}.s{i}-{n}"
        print(f"shard {i}/{n}: {len(comparisons)} comparisons")
    print(f"=========seed {args.seed}=========")
    print(f"Experiment on {args.target_block}, layer {args.target_layer}, "
          f"timestep {args.target_step}:")
    adapter = build_metric(args, device)
    loader = ImageLoader(args.image_size, preprocess=adapter.preprocess,
                         fast_decode=args.fast_decode)
    timer = StageTimer() if args.profile else None
    ctx = trace(args.profile_trace) if args.profile_trace else contextlib.nullcontext()
    try:
        with ctx:
            report = runner.run_2afc(
                comparisons, adapter.score_pairs, score_triplets=adapter.score_triplets,
                score_triplet_paths=adapter.score_triplet_paths, prewarm=adapter.prewarm,
                rule=rule, lower_better=adapter.lower_better, img_size=args.image_size,
                batch=args.batch_size, out_path=args.results, loader=loader, timer=timer)
    finally:
        loader.close()
    cache = getattr(adapter.scorer, "_moment_cache", None)
    if cache is not None:
        print(f"[moment cache] {cache.stats}")
    if timer is not None:
        timer.report()
    return report, adapter


def main():
    if len(sys.argv) < 2 or sys.argv[1] not in BENCHMARKS:
        print(f"usage: python -m diffsim_tpu_torch.cli.main "
              f"<{'|'.join(sorted(set(BENCHMARKS)))}> [flags]")
        raise SystemExit(2)
    run_benchmark(sys.argv[1], sys.argv[2:])


if __name__ == "__main__":
    main()
