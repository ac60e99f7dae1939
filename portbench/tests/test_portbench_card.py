"""On the card (``-m card``; skipped without one), at the cells' own sizes: the program's
numbers stay inside each cell's limits, while the control (the reference computed in fp8) falls
outside one of them, and so does SDXL's VAE run in bf16 (the program's ``vae_fp32=False``) where
the configuration states float32."""

import json
import os

import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _readings(workload, seed, control, **options):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import calibrate
    from portbench.harness import cli

    cli.cache_dirs()
    spec = cli.cell_spec(workload)
    config = spec["config"]
    spec["config"] = {**config, "options": {**config["options"], **options}}
    r = calibrate.readings(spec, seed, 3.0, torch.device("cuda:0"), control=control)
    print(json.dumps(r))
    assert r["failed"] == 0 and r["answers"] == spec["limits"]["sample"]
    return r, spec["limits"]


@pytest.mark.card
@pytest.mark.parametrize("workload", ["sd15-cute-reuse", "sdxl-1024-reuse"])
def test_program_inside_and_control_outside_the_limits(workload):
    r, limits = _readings(workload, 4242, True)
    names = [k for k in ("score_gap", "moment_gap") if k in limits]
    assert all(r[f"program_{k}"] <= limits[k] for k in names)
    assert any(r[f"control_{k}"] > limits[k] for k in names)


@pytest.mark.card
def test_sdxl_vae_in_bf16_falls_outside_the_limits():
    r, limits = _readings("sdxl-1024-reuse", 4243, False, vae_fp32=False)
    assert r["program_moment_gap"] > limits["moment_gap"]
