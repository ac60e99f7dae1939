"""Launch plans: how a wrapper brings a shape that its route admits inside its C entry's contract.

The C entries of K1-K4 take the last dimension (K1's, K3's and K4's head D, K2's channels C)
only at a multiple of a granule, and at most :data:`MAX_GRID_ROWS` rows a launch (the limit of
a grid's y axis: K1's and K4's B*H, K3's N, K2's 64-row tiles). A wrapper zero-pads the last
dimension to the granule (:func:`pad_to`), keeps what depends on the true width (the softmax
scale) at the caller's width, launches once a slice of rows (:func:`row_slices`) at a pointer
offset, and slices the output back. Each wrapper's ``launch_plan`` is a pure function of the
shape and dtype, so the CPU tests can hold every plan of a route-admitted shape to its C entry's
contract without a card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MAX_GRID_ROWS = 65535  # a CUDA grid's y (and z) axis
HEAD_GRANULE = 8  # K1, K3 and K4: D % 8 == 0


class LaunchPlan(NamedTuple):
    """What one wrapper call launches: ``library``'s entry at width ``padded`` (the caller's
    ``width`` rounded up to the granule) once per [start, stop) slice of rows in ``slices``."""

    library: str
    width: int
    padded: int
    slices: tuple[tuple[int, int], ...]


def padded_width(width: int, granule: int) -> int:
    """``width`` rounded up to a multiple of ``granule``."""
    return width + -width % granule


def row_slices(rows: int, step: int = MAX_GRID_ROWS) -> tuple[tuple[int, int], ...]:
    """The [start, stop) ranges of at most ``step`` rows that cover ``rows`` (none for 0)."""
    return tuple((i, min(i + step, rows)) for i in range(0, rows, step))


def pad_to(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` with its last dimension zero-padded to ``width`` (``t`` itself if it has it)."""
    pad = width - t.shape[-1]
    return torch.nn.functional.pad(t, (0, pad)) if pad else t


def pad_head_dim(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its last dimension zero-padded to a multiple of 8, the attention kernels'
    granule (``t`` itself if it is one). Zero columns of Q and K add nothing to a logit and zero
    columns of V give zero output columns, so with the softmax scale of the unpadded width the
    padded call's first D output columns are the unpadded call's."""
    return pad_to(t, padded_width(t.shape[-1], HEAD_GRANULE))
