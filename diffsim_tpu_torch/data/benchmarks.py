"""Benchmark protocol planners (the port's own copy of ``diffsim_tpu/data/benchmarks.py``).

Each planner replicates one reference script's sampling protocol (seeded RNG, same draw
sequence) and returns a flat list of :class:`Comparison` objects, so that the scorer can batch
pairs across the whole benchmark. Directory listings are ``sorted()`` and missing parallel
directories are skipped. Pure host code: the same seed gives the same plan as the JAX package.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
import random

IMG_EXTS = (".png", ".jpg", ".jpeg")


@dataclasses.dataclass(frozen=True)
class Comparison:
    """One 2AFC decision: is sim(a, b) greater than sim(a, c)?

    ``vote``: None => correct iff b wins (same-category protocols); 0/1 => the human answer
    (NIGHTS left_vote / DreamBench preference; 1 means "b is the better match" for NIGHTS and
    "c is better" for DreamBench — see each reference script's ``predicted`` mapping)."""

    a: str
    b: str
    c: str
    prompt: str
    vote: int | None = None
    meta: str = ""


def _images_in(d: str) -> list[str]:
    try:
        return sorted(f for f in os.listdir(d) if f.lower().endswith(IMG_EXTS))
    except FileNotFoundError:
        return []


def _sorted_walk(top: str):
    for root, dirs, files in os.walk(top):
        dirs.sort()
        yield root, dirs, sorted(files)


# ---------------------------------------------------------------------------
# CUTE (reference cute_main.py:52-108): per class x 10 experiments, A/B from one
# level-3 dir, C = the same level-3 name under a different level-2 dir.
# ---------------------------------------------------------------------------


def cute(image_path: str, seed: int) -> list[Comparison]:
    rng = random.Random(seed)
    out: list[Comparison] = []
    for cls in sorted(os.listdir(image_path)):
        cls_dir = os.path.join(image_path, cls)
        if cls in ("main.py", ".DS_Store") or not os.path.isdir(cls_dir):
            continue
        prompt = f"The photo of a {cls}"
        for _ in range(10):
            for subdir, dirs_lvl2, _files in _sorted_walk(cls_dir):
                for dir_lvl2 in dirs_lvl2:
                    lvl2_path = os.path.join(subdir, dir_lvl2)
                    lvl3 = sorted(
                        d for d in os.listdir(lvl2_path) if os.path.isdir(os.path.join(lvl2_path, d))
                    )
                    if not lvl3:
                        continue
                    sel3 = rng.choice(lvl3)
                    sel3_path = os.path.join(lvl2_path, sel3)
                    files = _images_in(sel3_path)
                    if len(files) < 2:
                        continue
                    img_a, img_b = rng.sample(files, 2)
                    others = [d for d in dirs_lvl2 if d != dir_lvl2]
                    if not others:
                        continue
                    other2 = rng.choice(others)
                    other3_path = os.path.join(subdir, other2, sel3)
                    other_files = _images_in(other3_path)
                    if not other_files:
                        continue
                    img_c = rng.choice(other_files)
                    out.append(
                        Comparison(
                            a=os.path.join(sel3_path, img_a),
                            b=os.path.join(sel3_path, img_b),
                            c=os.path.join(other3_path, img_c),
                            prompt=prompt,
                            meta=cls,
                        )
                    )
    return out


# ---------------------------------------------------------------------------
# Sref / InstantStyle (reference style_main.py:48-76): 2000 random triplets over all
# directories holding >= 2 images.
# ---------------------------------------------------------------------------


def style(image_path: str, seed: int, prompt: str = "High quality image",
          num_triplets: int = 2000) -> list[Comparison]:
    rng = random.Random(seed)
    subdir_dict: dict[str, list[str]] = {}
    for root, dirs, _files in _sorted_walk(image_path):
        for d in dirs:
            full = os.path.join(root, d)
            images = [os.path.join(full, f) for f in _images_in(full)]
            if len(images) >= 2:
                subdir_dict[full] = images
    subdir_paths = list(subdir_dict)
    out: list[Comparison] = []
    if len(subdir_paths) < 2:
        return out
    for _ in range(num_triplets):
        dir_a, dir_c = rng.sample(subdir_paths, 2)
        img_a, img_b = rng.sample(subdir_dict[dir_a], 2)
        img_c = rng.choice(subdir_dict[dir_c])
        out.append(Comparison(a=img_a, b=img_b, c=img_c, prompt=prompt, meta=os.path.basename(dir_a)))
    return out


# ---------------------------------------------------------------------------
# NIGHTS (reference night_main.py:53-67): data.csv val split, ref vs left/right, human
# left_vote; per-row prompt "An image of a {prompt.lower()}".
# ---------------------------------------------------------------------------


def nights(image_path: str, seed: int = 0) -> list[Comparison]:
    out: list[Comparison] = []
    with open(os.path.join(image_path, "data.csv")) as f:
        for row in csv.DictReader(f):
            if row["split"] != "val":
                continue
            out.append(
                Comparison(
                    a=os.path.join(image_path, row["ref_path"]),
                    b=os.path.join(image_path, row["left_path"]),
                    c=os.path.join(image_path, row["right_path"]),
                    prompt=f"An image of a {row['prompt'].lower()}",
                    vote=int(row["left_vote"]),
                )
            )
    return out


# ---------------------------------------------------------------------------
# TID2013 (reference tid_main.py:60-99): 25 refs x 24 distortions; level-2 file vs
# level-3 file against the pristine reference, case-insensitive filename probing.
# ---------------------------------------------------------------------------


def _probe(image_path: str, candidates: tuple[str, ...]) -> str | None:
    for name in candidates:
        full = os.path.join(image_path, name)
        if os.path.exists(full):
            return full
    return None


def tid2013(image_path: str, seed: int = 0) -> list[Comparison]:
    out: list[Comparison] = []
    prompt = "High quality image"
    for ref_i in range(1, 26):
        ref = _probe(
            image_path,
            (f"I{ref_i:02}.BMP", f"i{ref_i:02}.bmp", f"i{ref_i:02}.BMP", f"I{ref_i:02}.bmp"),
        )
        if ref is None:
            continue
        for dist_i in range(1, 25):
            lvl2 = _probe(
                image_path,
                (
                    f"i{ref_i:02}_{dist_i:02}_2.bmp",
                    f"I{ref_i:02}_{dist_i:02}_2.BMP",
                    f"I{ref_i:02}_{dist_i:02}_2.bmp",
                    f"i{ref_i:02}_{dist_i:02}_2.BMP",
                ),
            )
            lvl3 = _probe(
                image_path,
                (
                    f"i{ref_i:02}_{dist_i:02}_3.bmp",
                    f"I{ref_i:02}_{dist_i:02}_3.BMP",
                    f"I{ref_i:02}_{dist_i:02}_3.bmp",
                    f"i{ref_i:02}_{dist_i:02}_3.BMP",
                ),
            )
            if lvl2 is None or lvl3 is None:
                continue
            out.append(Comparison(a=ref, b=lvl2, c=lvl3, prompt=prompt, meta=f"dist{dist_i}"))
    return out


# ---------------------------------------------------------------------------
# IPref (reference ipref_main.py:58-66): per IP class, fixed consistency-weight pairs
# against the original {cls}.JPG; higher weight must score more similar.
# ---------------------------------------------------------------------------

IPREF_PAIRS = [("1.0.png", "0.6.png"), ("0.8.png", "0.4.png"), ("0.6.png", "0.3.png"),
               ("0.4.png", "0.35.png"), ("0.3.png", "0.2.png")]


def ipref(image_path: str, original_path: str, seed: int = 0) -> list[Comparison]:
    out: list[Comparison] = []
    prompt = "High quality image"
    for cls in sorted(os.listdir(image_path)):
        cls_dir = os.path.join(image_path, cls)
        if not os.path.isdir(cls_dir):
            continue
        ref = os.path.join(original_path, f"{cls}.JPG")
        for img1, img2 in IPREF_PAIRS:
            out.append(
                Comparison(
                    a=ref,
                    b=os.path.join(cls_dir, img1),
                    c=os.path.join(cls_dir, img2),
                    prompt=prompt,
                    meta=cls,
                )
            )
    return out


# ---------------------------------------------------------------------------
# DreamBench++ (reference dreambench_main.py:57-122): per generator dir, merge two
# annotator groups (drop divergence > 2, average), pair targets with rating gap >= 2,
# sample <= 5 pairs per reference; 2AFC vs human preference.
# ---------------------------------------------------------------------------

_DREAMBENCH_JSON = {
    "blip_diffusion": "blip_diffusion-cp.json",
    "dreambooth": "dreambooth_sd-cp.json",
    "ip_adapter_plus_sdxl": "ip_adapter_plus_vit_h_sdxl-cp.json",
    "ip_adapter_sdxl": "ip_adapter_vit_g_sdxl-cp.json",
    "textual_inversion": "textual_inversion_sd-cp.json",
}


def _dreambench_json_name(pipe_dir: str) -> str | None:
    for key, name in _DREAMBENCH_JSON.items():
        if key in pipe_dir:
            # match the reference's elif chain ordering: plus_sdxl before sdxl
            if key == "ip_adapter_sdxl" and "ip_adapter_plus_sdxl" in pipe_dir:
                continue
            return name
    return None


def dreambench(image_path: str, seed: int, prompt: str = "High quality image") -> list[Comparison]:
    rng = random.Random(seed)
    rating_path = os.path.join(image_path, "data_human_rating")
    out: list[Comparison] = []
    for pipe_dir in sorted(os.listdir(image_path)):
        json_name = _dreambench_json_name(pipe_dir)
        if json_name is None:
            continue
        with open(os.path.join(rating_path, "merged_data/group1/", json_name)) as f:
            anno_1 = json.load(f)
        with open(os.path.join(rating_path, "merged_data/group2/", json_name)) as f:
            anno_2 = json.load(f)
        pipe_path = os.path.join(image_path, pipe_dir)
        src_dir = os.path.join(pipe_path, "src_image")
        tgt_dir = os.path.join(pipe_path, "tgt_image")
        text_dir = os.path.join(pipe_path, "text")
        for ref_image in sorted(os.listdir(src_dir)):
            result = {}
            for key, value in anno_1.items():
                if not key.startswith(ref_image) or key not in anno_2:
                    continue
                if abs(value - anno_2[key]) > 2:
                    continue
                result[key] = (value + anno_2[key]) / 2
            selected: dict[tuple, int] = {}
            for key_a, value_a in result.items():
                for key_b, value_b in result.items():
                    if key_a == key_b or abs(value_a - value_b) < 2:
                        continue
                    if (key_b, key_a) in selected:
                        continue
                    selected[(key_a, key_b)] = 0 if value_a > value_b else 1
            pairs = list(selected.items())
            if len(pairs) > 5:
                pairs = rng.sample(pairs, 5)
            ref_file = os.path.join(src_dir, ref_image, "0_0.jpg")
            for (key_a, key_b), pref in pairs:
                out.append(
                    Comparison(
                        a=ref_file,
                        b=os.path.join(tgt_dir, ref_image, f"{key_a[-1]}_0.jpg"),
                        c=os.path.join(tgt_dir, ref_image, f"{key_b[-1]}_0.jpg"),
                        # the reference reads per-target prompts but scores with the CLI
                        # --prompt (dreambench_main.py:114-122 reads them, :131 passes
                        # ``prompt`` = args.prompt); we keep the CLI prompt for parity
                        prompt=prompt,
                        vote=pref,
                        meta=pipe_dir,
                    )
                )
    return out
