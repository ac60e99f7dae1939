"""The work of a configuration's calls, counted once per shape by its reference over meta
tensors (``reference/<reference>.py``'s ``work_of``): FLOPs of a UNet row to the tap, of a VAE
encode and of a pair's readout, and the shapes of the self-attentions each runs. The count is of
the scoring math, whatever implements it."""

from __future__ import annotations

import dataclasses

from portbench.harness import system


@dataclasses.dataclass(frozen=True)
class Work:
    row_flops: float  # one UNet row (an image's uncond or cond half) to the tap
    image_flops: float  # one VAE encode
    pair_flops: float  # one pair's readout, both directions
    row_sites: tuple  # (heads, tokens, head dim) of each self-attention of a row
    image_sites: tuple  # the same, of a VAE encode

    def flops(self, rows: int, images: int, pairs: int) -> float:
        return rows * self.row_flops + images * self.image_flops + pairs * self.pair_flops


def of(config: dict) -> Work:
    return Work(**system.reference_of(config).work_of(config))
