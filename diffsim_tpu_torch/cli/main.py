"""Benchmark CLI of the port: ``python -m diffsim_tpu_torch.cli.main <benchmark> [flags]``
(counterpart of ``diffsim_tpu/cli/main.py``).

One executable for the reference's six 2AFC scripts (CUTE, Sref / InstantStyle, NIGHTS,
TID2013, IPref, DreamBench++) with the same flags, decision arithmetic and printout, batched on
the card. For example, CUTE with the reference's settings, on one card and on N:

    python -m diffsim_tpu_torch.cli.main cute --preset cute --image_path DIR
    torchrun --nproc_per_node N -m diffsim_tpu_torch.cli.main cute --preset cute --image_path DIR
"""

from __future__ import annotations

import argparse
import contextlib
import sys

from diffsim_tpu_torch.cli.args import arg_parse
from diffsim_tpu_torch.core.image import ImageLoader
from diffsim_tpu_torch.data import benchmarks
from diffsim_tpu_torch.metrics.registry import build_metric
from diffsim_tpu_torch.parallel import mesh
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


def join_world(args, device, module: str) -> None:
    """Join the process group (``torchrun``'s, or the caller's) and hold ``--num_devices`` to
    its size, before any model is built; outside a group, say how to use several cards."""
    mesh.init_from_env(device)
    mesh.check_world_size(args.num_devices, module)
    mesh.run_hint(module)


def run_benchmark(benchmark: str, argv=None, *, device=None):
    """Plan ``benchmark`` from the flags ``argv`` and score it; returns (report, the list of
    adapters that scored it: one, or ``--metric ensemble``'s three). ``device`` is the scoring
    device (None: this rank's card; the CPU tests pass "cpu").

    In a process group (``torchrun --nproc_per_node N -m diffsim_tpu_torch.cli.main ...``) each
    call's comparisons shard over the ranks; every rank returns the same report, and only the
    leader writes ``--results`` and prints."""
    args = arg_parse(argv)
    join_world(args, device, "diffsim_tpu_torch.cli.main")
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
        mesh.leader_print(f"shard {i}/{n}: {len(comparisons)} comparisons")
    mesh.leader_print(f"=========seed {args.seed}=========")
    mesh.leader_print(f"Experiment on {args.target_block}, layer {args.target_layer}, "
          f"timestep {args.target_step}:")
    timer = StageTimer() if args.profile else None
    ctx = trace(args.profile_trace) if args.profile_trace else contextlib.nullcontext()
    if args.metric == "ensemble":
        # the reference's three voters: diffsim, CLIP-I and DINOv2
        adapters = [build_metric(argparse.Namespace(**{**vars(args), "metric": m}), device)
                    for m in ("diffsim", "clip_i", "dino")]
        with ctx:
            report = runner.run_2afc_ensemble(
                comparisons, adapters, vote_based=rule in (runner.VOTE, runner.VOTE_GREATER),
                img_size=args.image_size, batch=args.batch_size, out_path=args.results,
                print_fn=mesh.leader_print, timer=timer)
        if timer is not None and mesh.is_leader():
            timer.report()
        return report, adapters

    adapter = build_metric(args, device)
    mask_fn = _mask_fn(args, adapter, device)
    loader = ImageLoader(args.image_size, preprocess=adapter.preprocess,
                         fast_decode=args.fast_decode)
    try:
        with ctx:
            report = runner.run_2afc(
                comparisons, adapter.score_pairs, score_triplets=adapter.score_triplets,
                score_triplet_paths=adapter.score_triplet_paths, prewarm=adapter.prewarm,
                rule=rule, lower_better=adapter.lower_better, img_size=args.image_size,
                batch=args.batch_size, out_path=args.results, loader=loader,
                print_fn=mesh.leader_print, timer=timer, mask_fn=mask_fn)
    finally:
        loader.close()
    cache = getattr(adapter.scorer, "_moment_cache", None)
    if cache is not None:
        mesh.leader_print(f"[moment cache] {cache.stats}")
    if timer is not None and mesh.is_leader():
        timer.report()
    return report, [adapter]



def _mask_fn(args, adapter, device):
    """``--use_mask``: the masks from the ``--mask_path`` tree, or made at score time by SAM's
    centre-point prompt (``--sam_weights``), U^2-Net saliency (``--matting_weights``) or the
    border-statistics heuristic; None without the flag or for a metric without masks."""
    if not args.use_mask:
        return None
    if not adapter.wants_masks:
        print(f"[warn] --use_mask has no effect for --metric {args.metric}")
        return None
    size = args.image_size
    if args.mask_path:
        from diffsim_tpu_torch.core.image import load_mask, mask_path_for

        return lambda path: load_mask(mask_path_for(path, args.image_path, args.mask_path), size)
    from diffsim_tpu_torch.core.image import mask_from_matting
    from diffsim_tpu_torch.metrics.ffa import U2NetMatting, heuristic_matting
    from diffsim_tpu_torch.metrics.registry import _load_params

    if args.sam_weights:
        from diffsim_tpu_torch.metrics.sam_masking import SamMasking

        matting = SamMasking(_load_params(args.sam_weights), device=device)
        print("[use_mask] generating masks with SAM (center-point prompt)")
    elif args.matting_weights:
        matting = U2NetMatting(_load_params(args.matting_weights), device=device)
        print("[use_mask] generating masks with U^2-Net saliency")
    else:
        matting = heuristic_matting
        print("[use_mask] generating masks with the border-statistics heuristic "
              "(pass --sam_weights/--matting_weights or --mask_path for "
              "model-quality masks)")
    return lambda path: mask_from_matting(matting, path, size)


def main():
    if len(sys.argv) < 2 or sys.argv[1] not in BENCHMARKS:
        print(f"usage: python -m diffsim_tpu_torch.cli.main "
              f"<{'|'.join(sorted(set(BENCHMARKS)))}> [flags]")
        raise SystemExit(2)
    run_benchmark(sys.argv[1], sys.argv[2:])


if __name__ == "__main__":
    main()
