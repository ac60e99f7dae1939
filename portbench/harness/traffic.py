"""What every kind of traffic shares. A mix is a data file of parameters
(``traffic/<mix>.json``) whose ``kind`` names the module that generates and drives its requests
(``traffic/<kind>.py``, found by name). Each kind makes the requests of a run from its seed, and
gives every seed the same amount of work (the same counts of new images, the same request sizes
and gaps), in another order and on other pixels. Pixels are uint8 images of a ring of ``ring``
random images made from the seed.

A kind's module holds ``prepare(run)``: from ``run`` (scorer, config, mix, seed, seconds,
kwargs, device) it warms the cell's shapes and returns {ring, loop}, where ``loop()`` measures
one window and returns a ``drive.Window``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np

from portbench.harness import by_name


def load(root: str, name: str) -> dict:
    with open(os.path.join(root, "traffic", f"{name}.json")) as f:
        return json.load(f)


def kind(mix: dict):
    """The module of the mix's kind, ``traffic/<kind>.py``."""
    return by_name.module("traffic", mix["kind"])


def make_ring(rng: np.random.Generator, n: int, size: int) -> np.ndarray:
    return rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def share_count(i: int, per_call: float) -> int:
    """New images in call ``i`` so that calls 0..i hold round((i + 1) * per_call) of them."""
    return math.floor((i + 1) * per_call + 0.5) - math.floor(i * per_call + 0.5)


@dataclasses.dataclass
class TripletCall:
    """One call's inputs. ``ring_idx`` (3, T): the ring image of each slot [a, b, c]."""

    ring_idx: np.ndarray
    paths: list | None = None  # three role lists of keys (calls through the moment cache)
    row_map: dict | None = None  # new keys -> pixels
    new: int = 0  # images the call encodes

    @property
    def triplets(self) -> int:
        return self.ring_idx.shape[1]


def streams(stream_cls, mix: dict, img_size: int, seed: int):
    """(ring, warm-up stream, window stream) of a closed-loop kind whose calls ``stream_cls``
    makes: the warm-up's keys and draws apart from the window's, so the window starts as a run
    starts."""
    ring = make_ring(np.random.default_rng([seed, 0]), mix["ring"], img_size)
    return (ring, stream_cls(mix, ring, np.random.default_rng([seed, 1]), "/portbench/warm"),
            stream_cls(mix, ring, np.random.default_rng([seed, 2]), "/portbench/run"))
