"""Retrieval and comparison-grid tool of the port (counterpart of
``diffsim_tpu/cli/retrieval.py``, with its subcommands and flags).

    # rank a gallery against each query with any --metric, one ranking .txt per query
    python -m diffsim_tpu_torch.cli.retrieval rank --query_path Q --gallery_path G \\
        --out_path R --metric diffsim --target_step 500 [CLI flags]

    # compose grids ([query | top-k] per metric row) from ranking dirs (needs matplotlib)
    python -m diffsim_tpu_torch.cli.retrieval grid --origin_path G --rank_dirs d1 d2 d3 \\
        --out_path grids/

A ranking .txt holds one "<name> <score>" line per gallery image, best first (the reference's
reader format). ``rank`` scores on ``cuda`` unless it is given ``device``; without a CUDA
device it raises. On N cards (``torchrun --nproc_per_node N -m diffsim_tpu_torch.cli.retrieval
rank ...``) each call's pairs shard over the ranks and rank 0 writes the rankings. matplotlib
is imported only inside ``grid``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from diffsim_tpu_torch.cli.args import arg_parse
from diffsim_tpu_torch.core.image import ImageLoader, load_image
from diffsim_tpu_torch.data.benchmarks import IMG_EXTS


def _list_images(root: str) -> list[str]:
    out = []
    for dirpath, _dirs, files in os.walk(root):
        for f in sorted(files):
            if f.lower().endswith(IMG_EXTS):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


def rank(argv, *, device=None):
    """Rank the gallery against each query and write ``<out_path>/<query>.txt``. A metric with
    the moment-cache path ranks through it (:func:`_rank_cached`); any other scores pairs in
    ``--batch_size`` calls."""
    from diffsim_tpu_torch.cli.main import join_world
    from diffsim_tpu_torch.metrics.registry import build_metric
    from diffsim_tpu_torch.parallel import mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--query_path", required=True)
    ap.add_argument("--gallery_path", required=True)
    ap.add_argument("--out_path", required=True)
    ap.add_argument("--top_k", type=int, default=0, help="0 = write full ranking")
    ns, rest = ap.parse_known_args(argv)
    args = arg_parse(rest + ["--image_path", ns.gallery_path, "--out_path", ns.out_path])
    join_world(args, device, "diffsim_tpu_torch.cli.retrieval rank")
    leader = mesh.is_leader()

    adapter = build_metric(args, device)
    loader = ImageLoader(args.image_size, preprocess=adapter.preprocess,
                         fast_decode=args.fast_decode)
    queries = _list_images(ns.query_path) if os.path.isdir(ns.query_path) else [ns.query_path]
    gallery = _list_images(ns.gallery_path)
    if leader:
        os.makedirs(ns.out_path, exist_ok=True)
    try:
        if adapter.score_triplet_paths is None:
            gal_pix = loader.load_batch(gallery)
        for q in queries:
            if adapter.score_triplet_paths is not None:
                scores = _rank_cached(adapter, loader, q, gallery, args)
            else:
                q_pix = np.repeat(loader.load_batch([q]), len(gallery), axis=0)
                scores = []
                for start in range(0, len(gallery), args.batch_size):
                    end = start + args.batch_size
                    s = adapter.score_pairs(q_pix[start:end], gal_pix[start:end],
                                            [args.prompt] * (min(end, len(gallery)) - start))
                    scores.extend(float(x) for x in s)
            order = np.argsort(scores)
            if not adapter.lower_better:
                order = order[::-1]
            if ns.top_k:
                order = order[: ns.top_k]
            if not leader:
                continue
            name = os.path.splitext(os.path.basename(q))[0]
            out_file = os.path.join(ns.out_path, f"{name}.txt")
            with open(out_file, "w") as f:
                for i in order:
                    gal_name = os.path.splitext(os.path.basename(gallery[i]))[0]
                    f.write(f"{gal_name} {scores[i]:.6f}\n")
            print(f"wrote {out_file}")
    finally:
        loader.close()
    return adapter


def _rank_cached(adapter, loader, query: str, gallery: list[str], args) -> list[float]:
    """Rank through the device moment cache: gallery pairs pack two a triplet — (query,
    G_2i, G_2i+1) scores sim(Q, G_2i) and sim(Q, G_2i+1) with the query's encode and forward
    shared — and every image is keyed by path, so across queries the gallery's moments upload
    and encode once. An odd gallery repeats its last image. The last call scores only the
    triplets left (the JAX tool pads it to the batch for XLA's one compiled shape)."""
    g = list(gallery) + ([gallery[-1]] if len(gallery) % 2 else [])
    pb, pc = g[0::2], g[1::2]
    bs = max(1, args.batch_size)
    scores: list[float] = []
    inflight: list = []  # bounded queue (the runner's pattern):
    PREFETCH = 2  # dispatch overlaps the previous fetch without an unbounded backlog

    def drain(limit):
        while len(inflight) > limit:
            s_ab, s_ac = inflight.pop(0)()
            for ab, ac in zip(s_ab, s_ac):  # de-interleave back to gallery order
                scores.append(float(ab))
                scores.append(float(ac))

    for start in range(0, len(pb), bs):
        b, c = pb[start:start + bs], pc[start:start + bs]
        inflight.append(adapter.score_triplet_paths(
            [query] * len(b), b, c, prompts=args.prompt, blocking=False, loader=loader))
        drain(PREFETCH)
    drain(0)
    return scores[: len(gallery)]


def _read_ranked_paths(rank_file: str, origin_path: str, k: int = 4) -> list[str]:
    paths = []
    with open(rank_file) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            name = parts[0]
            for ext in (".png", ".jpg", ".jpeg"):
                cand = os.path.join(origin_path, name + ext)
                if os.path.exists(cand):
                    paths.append(cand)
                    break
            else:
                # reference layout: "<cls>_<imgid>" under origin/<cls>/<imgid>.png
                if "_" in name:
                    cls, img_id = name.rsplit("_", 1)
                    cand = os.path.join(origin_path, cls, f"{img_id}.png")
                    if os.path.exists(cand):
                        paths.append(cand)
            if len(paths) >= k:
                break
    return paths


def grid(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--origin_path", required=True)
    ap.add_argument("--rank_dirs", nargs="+", required=True,
                    help="one ranking dir per grid row (e.g. diffsim clip dino)")
    ap.add_argument("--query_dir", default=None, help="where query images live (default origin)")
    ap.add_argument("--out_path", required=True)
    ap.add_argument("--top_k", type=int, default=4)
    ns = ap.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(ns.out_path, exist_ok=True)
    query_dir = ns.query_dir or ns.origin_path
    rank_files = sorted(f for f in os.listdir(ns.rank_dirs[0]) if f.endswith(".txt"))
    for rf in rank_files:
        name = rf[:-4]
        query = None
        for ext in (".png", ".jpg", ".jpeg"):
            cand = os.path.join(query_dir, name + ext)
            if os.path.exists(cand):
                query = cand
                break
        if query is None:
            print(f"skipping {rf}: query image not found")
            continue
        rows = []
        for d in ns.rank_dirs:
            ranked = _read_ranked_paths(os.path.join(d, rf), ns.origin_path, ns.top_k)
            rows.append([query] + ranked)
        fig, axes = plt.subplots(len(rows), ns.top_k + 1,
                                 figsize=(3 * (ns.top_k + 1), 3 * len(rows)))
        axes = np.atleast_2d(axes)
        for r, row in enumerate(rows):
            for c in range(ns.top_k + 1):
                axes[r, c].axis("off")
                if c < len(row):
                    axes[r, c].imshow(load_image(row[c]))
        plt.subplots_adjust(wspace=0.2, hspace=0.2)
        plt.tight_layout()
        save_path = os.path.join(ns.out_path, f"{name}.png")
        plt.savefig(save_path)
        plt.close(fig)
        print(f"Result save to {save_path}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ("rank", "grid"):
        print("usage: python -m diffsim_tpu_torch.cli.retrieval {rank|grid} [flags]")
        raise SystemExit(2)
    (rank if argv[0] == "rank" else grid)(argv[1:])


if __name__ == "__main__":
    main()
