"""DiT training CLI of the port (counterpart of ``diffsim_tpu/cli/dit_train.py``), with the JAX
CLI's flags and defaults:

    python -m diffsim_tpu_torch.cli.dit_train --data_path imagenet/train --results_dir results \
        --model DiT-XL/2 --image_size 256 --global_batch_size 256 --epochs 1400

Data parallel on N cards: ``torchrun --nproc_per_node N -m diffsim_tpu_torch.cli.dit_train
--distributed ...``: each rank decodes and steps on its block of every global batch
(``--global_batch_size`` is the batch of all ranks together), the gradients are summed over the
ranks, and rank 0 writes the checkpoints and ``log.txt``. ``--distributed`` without a process
group raises; without it, a process that sees several cards runs on one and says how to use
them all. ``main`` takes ``device`` as a keyword (None: this rank's card; the CPU tests pass
"cpu"). Checkpoints are named by the trainer's step, which a ``--resume`` continues;
``--max_steps`` counts the steps of this run.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np

from diffsim_tpu_torch.data.imagefolder import ImageFolderDataset
from diffsim_tpu_torch.models import dit
from diffsim_tpu_torch.parallel import mesh
from diffsim_tpu_torch.train.dit_trainer import DiTTrainer, TrainConfig

MODULE = "diffsim_tpu_torch.cli.dit_train"


def create_logger(results_dir: str) -> logging.Logger:
    """The logger of the published trainer: rank 0 (the one process on one card) logs to
    ``results_dir/log.txt`` and to stdout, the other ranks nowhere. The handlers are the
    logger's own, set anew on each call, so runs in one process each write their own log."""
    logger = logging.getLogger(__name__)
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    if mesh.is_leader():
        os.makedirs(results_dir, exist_ok=True)
        fmt = logging.Formatter("[%(asctime)s] %(message)s", datefmt="%Y-%m-%d %H:%M:%S")
        for handler in (logging.StreamHandler(sys.stdout),
                        logging.FileHandler(os.path.join(results_dir, "log.txt"))):
            handler.setFormatter(fmt)
            logger.addHandler(handler)
    else:
        logger.addHandler(logging.NullHandler())
    logger.setLevel(logging.INFO)
    logger.propagate = False
    return logger


def main(argv=None, *, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--results_dir", default="results")
    ap.add_argument("--model", default="DiT-XL/2", choices=list(dit.MODELS))
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=1400)
    ap.add_argument("--global_batch_size", type=int, default=256)
    ap.add_argument("--global_seed", type=int, default=0)
    ap.add_argument("--log_every", type=int, default=100)
    ap.add_argument("--ckpt_every", type=int, default=50_000)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--vae_weights", default=None, help=".npz with a 'vae' encoder tree")
    ap.add_argument("--model_scale", choices=["full", "tiny"], default="full")
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--remat", action="store_true",
                    help="checkpoint every DiT block (activations recomputed in the backward; "
                         "numerics unchanged)")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 model compute with float32 master weights/optimizer/EMA")
    ap.add_argument("--distributed", action="store_true",
                    help="data parallel over the ranks of a torchrun process group (required "
                         "there; it raises without one)")
    args = ap.parse_args(argv)
    if not mesh.init_from_env(device) and args.distributed:
        raise RuntimeError(f"--distributed runs one process a card in a process group: launch "
                           f"torchrun --nproc_per_node N -m {MODULE} --distributed ...")
    mesh.run_hint(f"{MODULE} --distributed")
    rank, size = mesh.world()

    logger = create_logger(args.results_dir)
    cfg = TrainConfig(image_size=args.image_size, model=args.model, seed=args.global_seed,
                      remat=args.remat, compute_dtype="bfloat16" if args.bf16 else None)
    dit_cfg = vae_cfg = None
    if args.model_scale == "tiny":
        from diffsim_tpu_torch.models.vae import VAEConfig

        dit_cfg = dit.DiTConfig.tiny(input_size=args.image_size // 2, learn_sigma=True)
        vae_cfg = VAEConfig.tiny()
    vae_params = None
    if args.vae_weights:
        from diffsim_tpu_torch.convert.store import load_params

        vae_params = load_params(args.vae_weights)["vae"]
    trainer = DiTTrainer(cfg, dit_cfg=dit_cfg, vae_cfg=vae_cfg, vae_params=vae_params,
                         device=device)
    if args.resume:
        trainer.restore(os.path.abspath(args.resume))
        logger.info(f"resumed from {args.resume} at step {trainer.step}")

    data = ImageFolderDataset(args.data_path, args.image_size, seed=args.global_seed)
    logger.info(f"dataset: {len(data)} images, {len(data.classes)} classes")

    steps = 0
    t0 = time.time()
    running = []
    for epoch in range(args.epochs):
        logger.info(f"beginning epoch {epoch}")
        for pixels, labels in data.epoch_batches(args.global_batch_size,
                                                 process_slice=(rank, size)):
            metrics = trainer.train_step(pixels, labels)
            running.append(metrics["loss"])
            steps += 1
            if trainer.step % args.log_every == 0:
                dt = time.time() - t0
                logger.info(f"(step={trainer.step:07d}) train loss: {np.mean(running):.4f}, "
                            f"steps/sec: {len(running) / dt:.2f}")
                running = []
                t0 = time.time()
            if trainer.step % args.ckpt_every == 0:
                path = os.path.abspath(os.path.join(args.results_dir,
                                                    f"ckpt_{trainer.step:07d}"))
                trainer.save(path)
                logger.info(f"saved checkpoint to {path}")
            if args.max_steps and steps >= args.max_steps:
                logger.info("done (max_steps)")
                return trainer
    logger.info("done")
    return trainer


if __name__ == "__main__":
    main()
