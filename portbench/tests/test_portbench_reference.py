"""The plain reference (``reference/sd.py``) against the port's plain path at tiny widths on
the CPU, in float32, both sides holding the benchmark's weights: the triplet and pair scores of
both backbones agree to float32 rounding, and the control (fp8 products) does not."""

import numpy as np
import pytest
import torch

from portbench.harness import system, weights
from portbench.reference import sd

TOL = 1e-5  # float32 rounding through a 2-level UNet; the scores are cosines near 1


def _pixels(n, size, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


@pytest.mark.parametrize("name", ["sd15", "sdxl"])
def test_reference_matches_the_port(tiny, name):
    cfg = tiny(name)
    cpu = torch.device("cpu")
    w = weights.make(cfg, 7, cpu)
    scorer = system.of(cfg).build_scorer(cfg, cpu, w)
    kw = system.of(cfg).score_kwargs(cfg)
    pix = _pixels(6, cfg["img_size"])
    s_ab, s_ac = scorer.score_triplet_batch(pix[0:2], pix[2:4], pix[4:6], **kw)
    pairs = scorer.score_batch(pix[0:2], pix[2:4], **kw)
    ref = sd.Reference(cfg, w, cpu)
    for t in range(2):
        r_ab, r_ac = ref.triplet(pix[[t, 2 + t, 4 + t]])
        assert abs(r_ab - s_ab[t]) < TOL and abs(r_ac - s_ac[t]) < TOL
        assert abs(ref.pair(pix[[t, 2 + t]]) - pairs[t]) < TOL
    ctl = sd.Reference(cfg, w, cpu, "fp8")
    assert max(abs(ctl.triplet(pix[[t, 2 + t, 4 + t]])[0] - s_ab[t]) for t in range(2)) > TOL


def test_weights_repeat_from_the_seed(tiny):
    cfg = tiny("sd15")
    a, b, c = (weights.make(cfg, s, "cpu") for s in (5, 5, 6))
    for part in a:
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k])
    assert not torch.equal(a["unet"]["conv_in.weight"], c["unet"]["conv_in.weight"])
    assert torch.all(a["unet"]["conv_in.bias"] == 0)
    assert torch.all(a["unet"]["norm_out.weight"] == 1)


def test_noise_coefficients_follow_the_schedules():
    t, a, b = sd.noise_coefficients("pndm", 600)
    assert t == 401.0 and abs(a * a + b * b - 1.0) < 1e-12
    t, a, b = sd.noise_coefficients("euler", 900)
    assert t == 100.0 and a > 1.0  # the initial-noise amplification of the Euler pipeline
