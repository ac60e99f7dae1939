"""The port's DiT training and sampling CLIs on the CPU at tiny scale (``device="cpu"`` is a
keyword of their ``main``): ``dit_train`` writes its log and checkpoints and ``--resume``
continues the step count; ``dit_sample`` reads that checkpoint, or a ``.npz`` holding ``dit``
and ``vae_decoder`` trees written by the port's ``save_params``, and writes a grid PNG and an
``arr_0`` ``.npz`` of uint8 images; ``--distributed`` outside a process group raises, naming
torchrun, and a process that sees several cards says how to use them all."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from diffsim_tpu_torch.cli import dit_sample, dit_train
from diffsim_tpu_torch.convert import bridge
from diffsim_tpu_torch.convert.store import load_params, save_params
from diffsim_tpu_torch.models.vae import Decoder, VAEConfig
from diffsim_tpu_torch.train.dit_trainer import STATE_FILE

SIZE = 16  # tiny scale: the tiny VAE halves, so the tiny DiT sees an 8 x 8 latent
CLASSES = 10  # DiTConfig.tiny's


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models run faster on one intra-op thread than on many, most of all while the
    suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_path(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_images")
    rng = np.random.default_rng(0)
    for name in ("a", "b"):
        os.makedirs(root / name)
        for i in range(4):
            Image.fromarray(rng.integers(0, 256, (24, 20, 3), dtype=np.uint8)).save(
                root / name / f"{i}.jpg")
    return str(root)


def _train_args(data_path, results, *extra):
    return ["--data_path", data_path, "--results_dir", results, "--model_scale", "tiny",
            "--image_size", str(SIZE), "--global_batch_size", "4", "--log_every", "1",
            "--ckpt_every", "1", "--max_steps", "2", *extra]


@pytest.fixture(scope="module")
def trained(data_path, tmp_path_factory):
    results = str(tmp_path_factory.mktemp("results"))
    trainer = dit_train.main(_train_args(data_path, results), device="cpu")
    return results, trainer


def test_dit_train_writes_its_log_and_checkpoints_and_resumes(data_path, trained, capsys):
    results, trainer = trained
    assert trainer.step == 2
    log = open(os.path.join(results, "log.txt")).read()
    assert "dataset: 8 images, 2 classes" in log
    assert "(step=0000001) train loss:" in log and "(step=0000002) train loss:" in log
    assert "done (max_steps)" in log
    for step in (1, 2):
        assert os.path.exists(os.path.join(results, f"ckpt_{step:07d}", STATE_FILE))
    ckpt = os.path.join(results, "ckpt_0000002")
    resumed = dit_train.main(_train_args(data_path, results, "--resume", ckpt), device="cpu")
    assert resumed.step == 4
    log = open(os.path.join(results, "log.txt")).read()
    assert f"resumed from {ckpt} at step 2" in log
    assert "(step=0000004) train loss:" in log
    assert os.path.exists(os.path.join(results, "ckpt_0000004", STATE_FILE))
    assert "(step=0000004)" in capsys.readouterr().out  # the log also goes to stdout


def _sample_args(out, *extra):
    return ["--model_scale", "tiny", "--image_size", str(SIZE), "--num_classes", str(CLASSES),
            "--class_labels", "1", "2", "3", "4", "5", "--num_sampling_steps", "3",
            "--out", out, *extra]


def test_dit_sample_from_a_checkpoint_directory(trained, tmp_path):
    """Without a decoder the grid shows the latents: five 8 x 8 tiles, four to a row."""
    results, _ = trained
    out = str(tmp_path / "grid.png")
    dit_sample.main(_sample_args(out, "--ckpt", os.path.join(results, "ckpt_0000002")),
                    device="cpu")
    with Image.open(out) as img:
        assert img.size == (4 * SIZE // 2, 2 * SIZE // 2) and img.mode == "RGB"


def test_dit_sample_from_an_npz_with_a_decoder(trained, tmp_path):
    """A ``.npz`` of ``dit`` and ``vae_decoder`` trees: decoded 16 px images in the grid, and
    with ``--num_fid_samples`` an ``arr_0`` of uint8 images in batches of ``--per_batch``,
    ancestral and DDIM."""
    _, trainer = trained
    with torch.device("meta"):
        decoder = Decoder(VAEConfig.tiny())
    rng = np.random.default_rng(1)
    decoder_state = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.1
                     for k, v in decoder.state_dict().items()}
    npz = str(tmp_path / "dit.npz")
    save_params(npz, {"dit": bridge.to_jax_tree(trainer.model.state_dict(), "dit"),
                      "vae_decoder": bridge.to_jax_tree(decoder_state, "vae_decoder")})
    assert sorted(load_params(npz)) == ["dit", "vae_decoder"]
    grid = str(tmp_path / "grid.png")
    dit_sample.main(_sample_args(grid, "--ckpt", npz), device="cpu")
    with Image.open(grid) as img:
        assert img.size == (4 * SIZE, 2 * SIZE)
    for extra in ((), ("--ddim",)):
        fid = str(tmp_path / "fid.npz")
        dit_sample.main(_sample_args(fid, "--ckpt", npz, "--num_fid_samples", "5",
                                     "--per_batch", "3", *extra), device="cpu")
        with np.load(fid) as f:
            assert f.files == ["arr_0"]
            assert f["arr_0"].shape == (5, SIZE, SIZE, 3) and f["arr_0"].dtype == np.uint8


def test_multi_device_runs_raise_naming_item_7(data_path, tmp_path, monkeypatch, capsys):
    """``--distributed`` outside a process group raises, naming torchrun, before a model is
    built. Outside a group, a process that sees several cards runs on one and prints how to use
    them all (here on the CPU, with two cards pretended)."""
    with monkeypatch.context() as m:
        m.setattr(dit_train, "DiTTrainer", None)  # building a model would fail here
        with pytest.raises(RuntimeError,
                           match="torchrun --nproc_per_node N -m diffsim_tpu_torch.cli.dit_train "
                                 "--distributed"):
            dit_train.main(_train_args(data_path, str(tmp_path), "--distributed"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    trainer = dit_train.main(_train_args(data_path, str(tmp_path / "one")), device="cpu")
    assert trainer.device == torch.device("cpu") and trainer.step == 2
    assert ("torchrun --nproc_per_node 2 -m diffsim_tpu_torch.cli.dit_train --distributed"
            in capsys.readouterr().out)
    dit_sample.main(_sample_args(str(tmp_path / "x.png")), device="cpu")
    assert os.path.exists(tmp_path / "x.png")
    assert ("torchrun --nproc_per_node 2 -m diffsim_tpu_torch.cli.dit_sample"
            in capsys.readouterr().out)
