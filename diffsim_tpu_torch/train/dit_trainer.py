"""DiT training and class-conditional sampling on PyTorch and CUDA.

Counterpart of ``diffsim_tpu/train/dit_trainer.py``, on one card or data parallel over the
ranks of a process group (one card a rank). Each step mirrors the JAX step:

* the frozen VAE encoder and ``sample_latents`` at ``vae_scaling``, uint8 pixels mapped to
  [-1, 1] as ``u8 / 127.5 - 1``;
* the diffusion's hybrid loss (MSE + VB, ``models/diffusion.py``), each example's loss
  multiplied by the timestep sampler's importance weight, then the mean;
* ``torch.optim.AdamW(lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0)``, the same update as
  ``optax.adamw(lr, weight_decay=0.0)``;
* the EMA ``e * d + p * (1 - d)`` in float32 after each step.

``compute_dtype="bfloat16"`` mirrors the JAX trainer's whole-tree cast: the master weights, the
optimizer state and the EMA stay float32, the forward runs on a bf16 copy of every floating
parameter through ``torch.func.functional_call``, the latents enter in bf16 and the output is
cast to float32; the gradients come back to the float32 weights through the casts. Not
``torch.autocast``, whose per-op policy computes another function.

Randomness: t comes from numpy (``UniformSampler`` on a generator seeded ``(seed, 0)``, as the
JAX trainer's first process seeds it). The VAE posterior noise, the diffusion noise and the label
dropout are drawn, in that order, from a ``torch.Generator`` on the device seeded from
``(seed, step)``, so a resumed run draws what an uninterrupted one would, as the JAX step's
``fold_in(key, step)`` does. ``train_step`` takes them injected instead (``latent_noise``,
``noise``, ``t``, ``drop``), which is how the tests hold it to the JAX step.

Data parallel (``parallel/mesh.py``): each rank steps on its contiguous block of the global
batch, takes every draw at the global batch from the same generators and keeps its own rows,
and scales its loss by the global batch, so the gradients summed over the ranks
(``mesh.all_reduce_sum_`` after the backward, in both compute dtypes) are one card's at the same
global batch; the AdamW state, the EMA and ``step`` stay identical on every rank. Sampling
shards the sample batch the same way and gathers the images.

Checkpoints hold ``{params, ema, opt, step}``, what the JAX trainer's orbax tree holds, as one
``torch.save`` file in a directory (:data:`STATE_FILE`), written by rank 0.
"""

from __future__ import annotations

import copy
import dataclasses
import os

import numpy as np
import torch

from diffsim_tpu_torch.convert import bridge
from diffsim_tpu_torch.convert.store import as_float32
from diffsim_tpu_torch.metrics.scorer_base import build_module, resolve_device, to_device_pixels
from diffsim_tpu_torch.models.diffusion import create_diffusion
from diffsim_tpu_torch.models.dit import MODELS, DiT
from diffsim_tpu_torch.models.vae import Decoder, Encoder, VAEConfig, sample_latents
from diffsim_tpu_torch.parallel import mesh
from diffsim_tpu_torch.train.timestep_sampler import UniformSampler

STATE_FILE = "trainer_state.pt"


@dataclasses.dataclass
class TrainConfig:
    image_size: int = 256
    model: str = "DiT-XL/2"
    lr: float = 1e-4  # the published DiT recipe: AdamW, constant 1e-4, no weight decay
    ema_decay: float = 0.9999
    seed: int = 0
    vae_scaling: float = 0.18215
    remat: bool = False  # checkpoint every DiT block: activations recomputed in the backward
    compute_dtype: str | None = None  # "bfloat16": bf16 model compute, f32 master weights


def _nchw(arr, device) -> torch.Tensor:
    """An injected NHWC array (the JAX package's layout) as a float32 NCHW tensor."""
    return torch.as_tensor(np.asarray(arr, np.float32), device=device).permute(0, 3, 1, 2)


class DiTTrainer:
    """DiT training state on one device: the model (float32 master weights), its EMA, AdamW and
    the frozen VAE encoder. ``vae_params`` is the JAX package's ``vae`` encoder tree; without
    it the encoder is random, as in the JAX trainer. Runs on this rank's card unless ``device``
    is given; without a CUDA device and without ``device`` it raises. In a process group of
    several ranks every rank must build the same weights (checked here)."""

    def __init__(self, cfg: TrainConfig | None = None, dit_cfg=None, vae_params=None,
                 vae_cfg: VAEConfig | None = None, timestep_sampler=None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg = cfg or TrainConfig()
        self.dit_cfg = dit_cfg or MODELS[cfg.model](input_size=cfg.image_size // 8,
                                                    learn_sigma=True)
        self.vae_cfg = vae_cfg or VAEConfig.sd()
        self.diffusion = create_diffusion(None, learn_sigma=self.dit_cfg.learn_sigma)
        self.compute_dtype = getattr(torch, cfg.compute_dtype) if cfg.compute_dtype else None
        gen = torch.Generator(device=self.device)
        gen.manual_seed(cfg.seed)
        with torch.device("meta"):
            model = DiT(self.dit_cfg)
        self.model = model.to_empty(device=self.device).init_weights(gen)
        self.ema = copy.deepcopy(self.model).requires_grad_(False)
        self.optimizer = torch.optim.AdamW(self.model.parameters(), lr=cfg.lr,
                                           betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=0.0)
        self.vae = build_module(lambda: Encoder(self.vae_cfg), vae_params, "vae", self.device,
                                torch.float32, gen)
        self.step = 0
        self.timestep_sampler = timestep_sampler or UniformSampler(self.diffusion.num_steps)
        self._t_rng = np.random.default_rng((cfg.seed, 0))
        mesh.check_same_weights(self, "DiTTrainer")

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def _step_generator(self) -> torch.Generator:
        seed = int(np.random.SeedSequence([self.cfg.seed, self.step]).generate_state(1)[0])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    def _forward(self, x, model_t, labels, drop):
        kw = {"drop": drop, "remat": self.cfg.remat}
        if self.compute_dtype is None:
            return self.model(x, model_t, labels, **kw)[0]
        params = {name: p.to(self.compute_dtype) if p.is_floating_point() else p
                  for name, p in self.model.named_parameters()}
        out, _ = torch.func.functional_call(self.model, params,
                                            (x.to(self.compute_dtype), model_t, labels), kw)
        return out

    def train_step(self, pixels, labels, *, latent_noise=None, noise=None, t=None,
                   drop=None) -> dict:
        """One step on this rank's block of NHWC pixels (uint8, or float in [-1, 1]) and its
        labels: the whole batch on one card, 1 / size of the global batch on each rank of a
        group. Returns the global batch's weighted mean loss and mean MSE as floats.
        ``latent_noise`` and ``noise`` (NHWC, the latents' shape), ``t`` ((B,) ints, weights
        then one) and ``drop`` ((B,) booleans) replace the step's draws; they are given at the
        global batch B, as the draws are taken."""
        device, size = self.device, mesh.world()[1]
        b = len(labels) * size
        rows = mesh.shard_rows(b)
        if t is None:
            t_host, w_host = self.timestep_sampler.sample(self._t_rng, b)
        else:
            t_host, w_host = np.asarray(t, np.int64), np.ones(b, np.float32)
        gen = self._step_generator()
        with torch.no_grad():
            moments = self.vae(to_device_pixels([pixels], device, torch.float32))
            mean_shape = (b, self.vae_cfg.latent_channels) + moments.shape[2:]
            eps_vae = (torch.randn(mean_shape, generator=gen, device=device)
                       if latent_noise is None else _nchw(latent_noise, device))[rows]
            latents = sample_latents(moments, self.cfg.vae_scaling, eps_vae)
        noise = (torch.randn(mean_shape, generator=gen, device=device) if noise is None
                 else _nchw(noise, device))[rows]
        p_drop = self.dit_cfg.class_dropout_prob
        if drop is None and p_drop > 0:
            drop = (torch.rand(b, generator=gen, device=device) < p_drop)[rows]
        elif drop is not None:
            drop = torch.as_tensor(np.asarray(drop, bool)[rows], device=device)
        labels = torch.as_tensor(np.asarray(labels, np.int64), device=device)
        t_dev = torch.as_tensor(t_host[rows], dtype=torch.long, device=device)
        weights = torch.as_tensor(w_host[rows], dtype=torch.float32, device=device)

        def model_fn(x, model_t):
            return self._forward(x, model_t, labels, drop).float()

        self.optimizer.zero_grad(set_to_none=True)
        losses = self.diffusion.training_losses(model_fn, latents, t_dev, noise)
        # this rank's share of the global batch's mean: the ranks' gradients sum to one card's
        loss = (losses["loss"] * weights).sum() / b
        loss.backward()
        sums = torch.stack([loss.detach(), losses["mse"].detach().sum() / b])
        mesh.all_reduce_sum_([p.grad for p in self.model.parameters()] + [sums])
        self.optimizer.step()
        self._update_ema()
        self.step += 1
        per_example = mesh.gather_rows(losses["loss"].detach(), b)
        self.timestep_sampler.update(t_host, per_example.cpu().numpy())
        loss, mse = sums.tolist()
        return {"loss": loss, "mse": mse}

    @torch.no_grad()
    def _update_ema(self) -> None:
        d = self.cfg.ema_decay
        ema = list(self.ema.parameters())
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, list(self.model.parameters()), alpha=1 - d)

    # ------------------------------------------------------------------
    # weights and checkpoints
    # ------------------------------------------------------------------

    def load_params(self, tree) -> None:
        """Take the JAX package's ``dit`` tree (a ``.npz``'s) as both the weights and the EMA,
        as the JAX sampler CLI does."""
        state = {k: torch.from_numpy(as_float32(v))
                 for k, v in bridge.from_jax_tree(tree, "dit").items()}
        self.model.load_state_dict(state, strict=True)
        self.ema.load_state_dict(state, strict=True)

    def build_decoder(self, tree) -> Decoder:
        """The VAE decoder from the JAX package's ``vae_decoder`` tree, on this device."""
        return build_module(lambda: Decoder(self.vae_cfg), tree, "vae_decoder", self.device,
                            torch.float32, None)

    def save(self, ckpt_dir: str) -> None:
        """Rank 0 writes; every rank returns once the file is complete."""
        if mesh.is_leader():
            os.makedirs(ckpt_dir, exist_ok=True)
            torch.save({"params": self.model.state_dict(), "ema": self.ema.state_dict(),
                        "opt": self.optimizer.state_dict(), "step": self.step},
                       os.path.join(ckpt_dir, STATE_FILE))
        mesh.barrier()

    def restore(self, ckpt_dir: str) -> None:
        path = os.path.join(ckpt_dir, STATE_FILE)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{ckpt_dir} holds no {STATE_FILE}: it is not a checkpoint of the port (the JAX "
                "package's orbax directories are not read). Save the JAX tree's params as a "
                ".npz with a 'dit' tree (diffsim_tpu.convert.save_params) and pass that to "
                "dit_sample --ckpt")
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(state["params"])
        self.ema.load_state_dict(state["ema"])
        self.optimizer.load_state_dict(state["opt"])
        self.step = int(state["step"])

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------

    @torch.no_grad()
    def sample(self, labels, generator: torch.Generator, cfg_scale: float | None = None,
               num_steps: int = 250, vae_decoder: Decoder | None = None,
               ddim: bool = False) -> np.ndarray:
        """Class-conditional sampling: ``num_steps`` respaced steps, ancestral or DDIM, with
        classifier-free guidance at ``cfg_scale`` on the first three eps channels (the
        published DiT quirk) when it is given, through the EMA weights. Returns NHWC latents,
        or images in about [-1, 1] when a decoder is given. In a process group each rank
        samples its block of the labels, every draw taken at the whole batch's shape, and every
        rank returns all the images: the ranks' ``generator`` states stay equal."""
        model = self.ema
        dcfg, total = self.dit_cfg, len(labels)
        rows = mesh.shard_rows(total)
        if total < mesh.world()[1]:
            raise ValueError(f"{total} samples on {mesh.world()[1]} ranks: sample at least one "
                             "image a rank")
        diffusion = create_diffusion(str(int(num_steps)), learn_sigma=dcfg.learn_sigma)
        labels = torch.as_tensor(np.asarray(labels, np.int64)[rows], device=self.device)
        n = len(labels)
        if cfg_scale is not None:
            y = torch.cat([labels, torch.full_like(labels, dcfg.num_classes)])

            def model_fn(x, model_t):
                out, _ = model(torch.cat([x, x]), torch.cat([model_t, model_t]), y)
                cond, uncond = out[:, :3].chunk(2)
                return torch.cat([uncond + cfg_scale * (cond - uncond), out[:n, 3:]], dim=1)
        else:

            def model_fn(x, model_t):
                return model(x, model_t, labels)[0]

        loop = diffusion.ddim_sample_loop if ddim else diffusion.p_sample_loop
        shape = (total, dcfg.in_channels, dcfg.input_size, dcfg.input_size)
        out = loop(model_fn, shape, generator, rows=rows)
        if vae_decoder is not None:
            out = vae_decoder(out / self.cfg.vae_scaling)
        return mesh.gather_rows(out.permute(0, 2, 3, 1).float().contiguous(), total).cpu().numpy()
