"""The PyTorch port stands alone: neither ``diffsim_tpu_torch`` nor ``chip_smoke.py``
imports JAX or the JAX package, and its entry points refuse to run on the CPU unless asked."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import diffsim_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(diffsim_tpu_torch.__path__,
                                                         "diffsim_tpu_torch."))


def test_port_and_chip_smoke_import_no_jax():
    modules = _port_modules() + ["chip_smoke"]
    for name in ("metrics.diffsim_sd15", "metrics.diffsim_dit", "models.dit", "cli.convert",
                 "convert.diffusion_import", "convert.torch_import", "models.clip_vision",
                 "models.ip_adapter", "metrics.ffa", "metrics.clip_i", "metrics.dino",
                 "metrics.lpips", "metrics.vgg_gram", "models.dinov2", "models.vgg",
                 "models.u2net", "convert.u2net_import", "models.diffusion",
                 "train.dit_trainer", "train.timestep_sampler", "data.imagefolder",
                 "cli.dit_train", "cli.dit_sample", "models.sam", "convert.sam_import",
                 "metrics.sam_masking", "cli.serve", "cli.retrieval", "cli.compare_results",
                 "runtime.viz", "parallel.mesh"):
        assert f"diffsim_tpu_torch.{name}" in modules
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'diffsim_tpu' or m.startswith('diffsim_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


SCORERS = {"DiffSimSD15": "metrics.diffsim_sd15", "DiffSimXL": "metrics.diffsim_xl",
           "DiffSimDiT": "metrics.diffsim_dit", "CLIPScore": "metrics.clip_i",
           "Dinov2Score": "metrics.dino", "DinoScore": "metrics.dino", "LPIPS": "metrics.lpips",
           "VGGGram": "metrics.vgg_gram", "ForegroundFeatureAveraging": "metrics.ffa",
           "U2NetMatting": "metrics.ffa", "DiTTrainer": "train.dit_trainer",
           "SamMasking": "metrics.sam_masking"}


@pytest.mark.parametrize("scorer", sorted(SCORERS))
def test_scorer_without_a_device_raises_when_cuda_is_absent(monkeypatch, scorer):
    import importlib

    cls = getattr(importlib.import_module(f"diffsim_tpu_torch.{SCORERS[scorer]}"), scorer)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(None) if scorer in ("U2NetMatting", "SamMasking") else cls()


def test_chip_smoke_refuses_to_run_without_cuda():
    """With no CUDA device the script exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run for real")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
