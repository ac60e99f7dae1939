"""The knee of an open-loop service cell: the highest offered rate at which the backlog does not
grow over a window, found once by a sweep on the card, in one process.

    python3 portbench/sweep.py --workload sd15-serve-over --rates 10 14 18 22 26 --seconds 20

For each rate (requests/s, the mix's sizes) one window runs into a fresh batcher; the line gives
the pairs/s offered and completed, the latency's median and 95th percentile, and the median
latency of the last quarter of requests over the first quarter's (a backlog that grows drives
it up). The rate that a cell's mix offers is written into its file by hand from these lines.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench.harness import cli  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cli.cache_dirs()
    torch.set_num_threads(cli.HOST_THREADS)
    spec = cli.cell_spec(args.workload)
    s = cli.prepare(spec, args.seed, args.seconds, torch.device("cuda:0"))
    for rate in args.rates:
        mix = {**spec["mix"], "rate_per_s": rate}
        w = s.loop(mix)
        done = sorted(w.done, key=lambda d: d.t_done - d.latency_ms / 1e3)
        lat = np.asarray([d.latency_ms for d in done])
        q = max(1, len(lat) // 4)
        pairs = sum(d.pairs for d in done if d.scores is not None)
        offered = sum(d.pairs for d in done) / args.seconds
        print(json.dumps({
            "rate_per_s": rate, "requests": w.attempted, "failed": w.failed,
            "offered_pairs_per_s": offered, "completed_pairs_per_s": pairs / (w.t_end - w.t0),
            "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
            "growth": float(np.median(lat[-q:]) / np.median(lat[:q])),
            "round_pairs": float(np.mean([p for p, _ in w.rounds])) if w.rounds else None,
            "round_ms": float(np.mean([m for _, m in w.rounds])) if w.rounds else None}),
            flush=True)
        w.rounds.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
