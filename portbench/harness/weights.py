"""Weights made from the run's seed, on the device, in the dtype each part is served in.

One normal draw for all the matrices of a part (N(0, ``STD``)), biases zero and the other vectors
(norm scales) one, as random-weight runs of Stable Diffusion are initialised; then the
reference's ``shape_weights``, where it has one, gives them what a trained model's weights must
have for the score to see the image (``reference/sd.py``: the VAE's posterior). The parameter list
is the configuration's reference's (``reference/<reference>.py``), so the program gets the
weights by name, strictly, and the reference makes the same ones again from the same seed after
the program is gone.
"""

from __future__ import annotations

import torch

from portbench.harness import system

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
STD = 0.02  # of the matrices' normal draw


def make(config: dict, seed: int, device) -> dict:
    """{part: {name: tensor}} for every part of ``config`` (``unet``, ``vae``, ``text`` ...),
    each part in the dtype the configuration's ``part_dtypes`` gives it."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = {}
    ref = system.reference_of(config)
    modules = ref.build_modules(config, "meta")
    for part, mod in modules.items():
        shapes = {k: v.shape for k, v in mod.state_dict().items()}
        dtype = DTYPES[config["part_dtypes"][part]]
        mats = {k for k, s in shapes.items() if len(s) >= 2}
        vecs = [k for k in shapes if k not in mats]
        flat = torch.randn(sum(shapes[k].numel() for k in mats), generator=gen, device=device,
                           dtype=dtype).mul_(STD)
        zeros = torch.zeros(sum(shapes[k].numel() for k in vecs), device=device, dtype=dtype)
        ones = torch.ones_like(zeros)
        weights, off, voff = {}, 0, 0
        for k, s in shapes.items():
            n = s.numel()
            if k in mats:
                weights[k] = flat[off:off + n].view(s)
                off += n
            else:
                weights[k] = (zeros if k.endswith("bias") else ones)[voff:voff + n].view(s)
                voff += n
        out[part] = weights
    if hasattr(ref, "shape_weights"):
        ref.shape_weights(config, out, STD)
    return out
