"""Readings that a cell's correctness limit is set from, on the card, in one process.

    python3 portbench/calibrate.py --workload <name> --seeds 11 12 ... --control 11 12 13 \
        --seconds 5 [--options '{"vae_fp32": false}'] [--out readings.jsonl]

For each seed: the system is set up with that seed's weights and traffic, one short window runs
at the cell's own load, and the same sample of answers as a benchmark run takes is scored again
by the float32 reference; each number a run compares (``score_gap``, and ``moment_gap`` where
the cell's limits name it) is the program's reading. For the ``--control`` seeds
the reference computed in fp8 (``reference/sd.py``, ``precision="fp8"``), put in the program's
place, is held to the float32 reference on the same answers: the control's reading. With
``--options`` the program runs with those scorer options in place of the configuration's: where
they switch on the program's own path of a lower precision (``vae_fp32=false``: SDXL's VAE in
bf16), its reading is that control's. One JSON line a seed. The benchmark's own runs never run
this.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from portbench.harness import cli, correct  # noqa: E402


def readings(spec: dict, seed: int, seconds: float, device, control: bool) -> dict:
    s = cli.prepare(spec, seed, seconds, device)
    w = s.loop()
    picks, moments = cli.sample(spec, seed, s, w)
    ring = s.ring
    cli.release(s, device)
    compared, r32, m32 = cli.check(spec, seed, w, picks, moments, ring, device)
    out = {"seed": seed, "answers": len(picks), "calls": len(w.done), "failed": w.failed}
    out.update({f"program_{k}": c["value"] for k, c in compared.items() if k != "failed"})
    if control:
        ref8 = correct.reference(spec["config"], seed, device, "fp8")
        s8, m8 = correct.reference_answers(ref8, picks, ring)
        del ref8
        out["control_score_gap"] = correct.widest_gap(s8, r32)
        if "moment_gap" in compared:
            out["control_moment_gap"] = correct.moment_gap(m8, m32)
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--options", type=json.loads, default={})
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cli.cache_dirs()
    torch.set_num_threads(cli.HOST_THREADS)
    spec = cli.cell_spec(args.workload)
    config = spec["config"]
    spec["config"] = {**config, "options": {**config["options"], **args.options}}
    device = torch.device("cuda:0")
    for seed in args.seeds:
        line = json.dumps({**readings(spec, seed, args.seconds, device, seed in args.control),
                           "options": args.options})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
