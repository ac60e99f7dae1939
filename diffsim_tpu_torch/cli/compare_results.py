"""Cross-framework parity checker: rank correlation between two results JSONL files (the
port's copy of ``diffsim_tpu/cli/compare_results.py``).

The two packages draw their noise from different generators, so their scores are not equal one
by one; the criterion is ranking parity. Run the same benchmark in both with ``--results``,
then:

    python -m diffsim_tpu_torch.cli.compare_results ours.jsonl theirs.jsonl

Prints the Spearman rank correlation of the s_ab/s_ac streams, and decision agreement (the
fraction of comparisons where both runs pick the same winner).
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _load(path: str) -> dict[int, tuple[float, float]]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            out[rec["idx"]] = (rec["s_ab"], rec["s_ac"])
    return out


def spearman(x: np.ndarray, y: np.ndarray) -> float:
    def ranks(v):
        order = np.argsort(v)
        r = np.empty(len(v))
        r[order] = np.arange(len(v), dtype=np.float64)
        # average ties
        _, inv, counts = np.unique(v, return_inverse=True, return_counts=True)
        sums = np.zeros(len(counts))
        np.add.at(sums, inv, r)
        return sums[inv] / counts[inv]

    rx, ry = ranks(x), ranks(y)
    rx -= rx.mean()
    ry -= ry.mean()
    denom = np.sqrt((rx**2).sum() * (ry**2).sum())
    return float((rx * ry).sum() / denom) if denom else 0.0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ours")
    ap.add_argument("theirs")
    args = ap.parse_args(argv)
    a, b = _load(args.ours), _load(args.theirs)
    common = sorted(set(a) & set(b))
    if not common:
        raise SystemExit("no overlapping comparison indices")
    sa = np.array([s for i in common for s in a[i]])
    sb = np.array([s for i in common for s in b[i]])
    rho = spearman(sa, sb)
    agree = np.mean(
        [(a[i][0] > a[i][1]) == (b[i][0] > b[i][1]) for i in common]
    )
    print(json.dumps({
        "comparisons": len(common),
        "spearman": round(rho, 4),
        "decision_agreement": round(float(agree), 4),
    }))


if __name__ == "__main__":
    main()
