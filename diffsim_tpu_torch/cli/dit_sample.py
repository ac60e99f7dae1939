"""DiT sampling CLI of the port (counterpart of ``diffsim_tpu/cli/dit_sample.py``): a grid of
class-conditional samples, or mass sampling packed into an ``arr_0`` ``.npz`` of uint8 images
(the ADM evaluation suite's layout), with the JAX CLI's flags and defaults:

    python -m diffsim_tpu_torch.cli.dit_sample --ckpt dit.npz --vae_weights sd15.npz \
        --image_size 256 --cfg_scale 4.0 --out sample.png
    python -m diffsim_tpu_torch.cli.dit_sample --ckpt dit.npz ... --num_fid_samples 50000 \
        --per_batch 64 --out samples.npz

``--ckpt`` is a ``.npz`` with a ``dit`` tree (and a ``vae_decoder`` tree where it has one) or a
checkpoint directory of the port's trainer; ``--vae_weights`` a ``.npz`` with a ``vae_decoder``
tree. Without a decoder the grid shows the latents. On N cards (``torchrun --nproc_per_node N
-m diffsim_tpu_torch.cli.dit_sample ...``) each batch's samples shard over the ranks, every draw
taken at the whole batch's shape, so the images equal one card's; rank 0 writes them. ``main``
takes ``device`` as a keyword (None: this rank's card).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from diffsim_tpu_torch.convert.store import load_params
from diffsim_tpu_torch.models import dit
from diffsim_tpu_torch.parallel import mesh
from diffsim_tpu_torch.train.dit_trainer import DiTTrainer, TrainConfig


def main(argv=None, *, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=None,
                    help=".npz with a 'dit' tree, or a checkpoint directory of dit_train")
    ap.add_argument("--vae_weights", default=None, help=".npz with a 'vae_decoder' tree")
    ap.add_argument("--model", default="DiT-XL/2", choices=list(dit.MODELS))
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--num_classes", type=int, default=1000)
    ap.add_argument("--cfg_scale", type=float, default=4.0)
    ap.add_argument("--num_sampling_steps", type=int, default=250)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--class_labels", type=int, nargs="+",
                    default=[207, 360, 387, 974, 88, 979, 417, 279])
    ap.add_argument("--num_fid_samples", type=int, default=None)
    ap.add_argument("--per_batch", type=int, default=32)
    ap.add_argument("--ddim", action="store_true")
    ap.add_argument("--model_scale", choices=["full", "tiny"], default="full")
    ap.add_argument("--out", default="sample.png")
    args = ap.parse_args(argv)
    mesh.init_from_env(device)
    mesh.run_hint("diffsim_tpu_torch.cli.dit_sample")

    cfg = TrainConfig(image_size=args.image_size, model=args.model)
    dit_cfg = vae_cfg = None
    if args.model_scale == "tiny":
        from diffsim_tpu_torch.models.vae import VAEConfig

        dit_cfg = dit.DiTConfig.tiny(input_size=args.image_size // 2, learn_sigma=True,
                                     num_classes=args.num_classes)
        vae_cfg = VAEConfig.tiny()
    trainer = DiTTrainer(cfg, dit_cfg=dit_cfg, vae_cfg=vae_cfg, device=device)

    decoder = None
    if args.ckpt:
        if args.ckpt.endswith(".npz"):
            tree = load_params(args.ckpt)
            trainer.load_params(tree["dit"])
            if "vae_decoder" in tree:
                decoder = trainer.build_decoder(tree["vae_decoder"])
        else:
            trainer.restore(args.ckpt)
    if decoder is None and args.vae_weights:
        decoder = trainer.build_decoder(load_params(args.vae_weights)["vae_decoder"])

    generator = torch.Generator(device=trainer.device)
    generator.manual_seed(args.seed)
    kw = dict(cfg_scale=args.cfg_scale, num_steps=args.num_sampling_steps, vae_decoder=decoder,
              ddim=args.ddim)
    if args.num_fid_samples:
        all_imgs = []
        rng = np.random.default_rng(args.seed)
        done = 0
        while done < args.num_fid_samples:
            n = min(args.per_batch, args.num_fid_samples - done)
            labels = rng.integers(0, args.num_classes, args.per_batch)
            out = trainer.sample(labels, generator, **kw)
            imgs = np.clip((np.asarray(out, np.float32) + 1) * 127.5, 0, 255).astype(np.uint8)
            all_imgs.append(imgs[:n])
            done += n
            mesh.leader_print(f"sampled {done}/{args.num_fid_samples}")
        arr = np.concatenate(all_imgs)
        if mesh.is_leader():
            np.savez(args.out, arr_0=arr)
        mesh.leader_print(f"saved {arr.shape} to {args.out}")
    else:
        out = trainer.sample(np.asarray(args.class_labels), generator, **kw)
        if mesh.is_leader():
            _save_grid(out, args.out, decoded=decoder is not None)
        mesh.leader_print(f"saved {args.out}")
    mesh.barrier()



def _save_grid(images: np.ndarray, path: str, decoded: bool, cols: int = 4):
    from PIL import Image

    arr = np.asarray(images, np.float32)
    if not decoded:  # latents: normalised for a viewable grid
        arr = (arr - arr.min()) / (arr.max() - arr.min() + 1e-8) * 2 - 1
        arr = arr[..., :3]
    arr = np.clip((arr + 1) * 127.5, 0, 255).astype(np.uint8)
    n, h, w, _ = arr.shape
    rows = (n + cols - 1) // cols
    grid = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i in range(n):
        r, c = divmod(i, cols)
        grid[r * h: (r + 1) * h, c * w: (c + 1) * w] = arr[i]
    Image.fromarray(grid).save(path)


if __name__ == "__main__":
    main()
