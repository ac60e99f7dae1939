"""Offline checkpoint conversion for the port, with numpy and torch alone (no JAX, no
``safetensors`` package, no ``ml_dtypes``). Counterpart of ``diffsim_tpu/cli/convert.py``, with
its flags and defaults; the ``.npz`` it writes has the JAX converter's keys and loads through
either package's ``--weights``.

    python -m diffsim_tpu_torch.cli.convert sd15 --unet u.safetensors --vae v.safetensors \\
        --text t.safetensors --out sd15.npz [--dtype bfloat16]
    python -m diffsim_tpu_torch.cli.convert sdxl --unet ... --vae ... --text ... --text2 ... \\
        --out ...
    python -m diffsim_tpu_torch.cli.convert dit  --ckpt DiT-XL-2-512x512.pt --vae v.safetensors \\
        --image_size 512 --out dit.npz   (a train-format checkpoint's EMA weights, as the
                                          published find_model takes them)
    python -m diffsim_tpu_torch.cli.convert clip   --model model.safetensors --out clip.npz
    python -m diffsim_tpu_torch.cli.convert dinov2 --model ... --size small|base --out ...
    python -m diffsim_tpu_torch.cli.convert dinov1 --model dino_vits8.pth --out ...
    python -m diffsim_tpu_torch.cli.convert vgg19  --model vgg19.pth --out ...
    python -m diffsim_tpu_torch.cli.convert lpips  --model lpips_vgg.pth --vgg vgg16.pth --out ...
    python -m diffsim_tpu_torch.cli.convert u2net  --model u2netp.pth --out u2netp.npz
                                          (lite or full, told apart by a stage1 width)
    python -m diffsim_tpu_torch.cli.convert sam    --model sam_vit_h.pth --out sam.npz
                                          (ViT-B, ViT-L or ViT-H, told apart by the
                                          embedding width)

``.safetensors`` files are read by ``convert/torch_import.load_safetensors``; anything else by
``torch.load``, unwrapping ``{"ema": ...}`` and ``{"model": ...}``.
"""

from __future__ import annotations

import argparse

import numpy as np

from diffsim_tpu_torch.convert import diffusion_import as DI
from diffsim_tpu_torch.convert import torch_import as TI
from diffsim_tpu_torch.convert.store import _flatten, save_params

FAMILIES = ("sd15", "sdxl", "dit", "clip", "dinov2", "dinov1", "vgg19", "lpips", "u2net",
            "sam")


def _load(path: str) -> dict:
    if path.endswith(".safetensors"):
        return TI.load_safetensors(path)
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "ema" in obj:  # DiT train-format checkpoint
        obj = obj["ema"]
    elif isinstance(obj, dict) and "model" in obj and not any(
        hasattr(v, "shape") for v in obj.values()
    ):
        obj = obj["model"]
    return TI.state_dict_numpy(obj)


def main(argv=None):
    ap = argparse.ArgumentParser(description="convert torch checkpoints to diffsim-tpu .npz")
    ap.add_argument("family", choices=FAMILIES)
    ap.add_argument("--unet")
    ap.add_argument("--vae")
    ap.add_argument("--text")
    ap.add_argument("--text2")
    ap.add_argument("--model")
    ap.add_argument("--ckpt")
    ap.add_argument("--vgg")
    ap.add_argument("--image_size", type=int, default=512)
    ap.add_argument("--size", default="small", choices=["small", "base"])
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    dtype = args.dtype if args.dtype == "bfloat16" else np.dtype(args.dtype)

    from diffsim_tpu_torch.models import clip_text, clip_vision, dinov2, dit, unet, vae, vgg

    if args.family in ("sd15", "sdxl"):
        ucfg = unet.UNetConfig.sd15() if args.family == "sd15" else unet.UNetConfig.sdxl()
        vcfg = vae.VAEConfig.sd() if args.family == "sd15" else vae.VAEConfig.sdxl()
        enc, dec = DI.convert_vae(_load(args.vae), vcfg)
        tree = {
            "unet": DI.convert_sd_unet(_load(args.unet), ucfg),
            "vae": enc,
            "vae_decoder": dec,
            "text": TI.convert_clip_text(_load(args.text), clip_text.CLIPTextConfig.sd15()),
        }
        if args.family == "sdxl":
            tree["text2"] = TI.convert_clip_text(
                _load(args.text2), clip_text.CLIPTextConfig.sdxl_big_g()
            )
    elif args.family == "dit":
        dcfg = dit.DiTConfig.xl2(input_size=args.image_size // 8)
        tree = {"dit": DI.convert_dit(_load(args.ckpt), dcfg)}
        if args.vae:
            enc, dec = DI.convert_vae(_load(args.vae), vae.VAEConfig.sd())
            tree["vae"] = enc
            tree["vae_decoder"] = dec
    elif args.family == "clip":
        sd = _load(args.model)
        tree = {
            "vision": TI.convert_clip_vision(sd, clip_vision.CLIPVisionConfig.b32()),
            "text": TI.convert_clip_text(sd, clip_text.CLIPTextConfig(
                hidden=512, heads=8, intermediate=2048, projection_dim=512)),
        }
    elif args.family == "dinov2":
        cfg = dinov2.DinoConfig.v2_small() if args.size == "small" else dinov2.DinoConfig.v2_base()
        tree = TI.convert_dinov2(_load(args.model), cfg)
    elif args.family == "dinov1":
        tree = TI.convert_dino_v1(_load(args.model), dinov2.DinoConfig.v1_vits8())
    elif args.family == "vgg19":
        tree = {"convs": TI.convert_vgg_features(_load(args.model), vgg.VGG19_CFG)["convs"]}
    elif args.family == "lpips":
        tree = TI.convert_lpips(_load(args.model), vgg.VGG16_CFG)
        if "vgg" not in tree and args.vgg:
            tree["vgg"] = TI.convert_vgg_features(_load(args.vgg), vgg.VGG16_CFG)
    elif args.family == "u2net":
        from diffsim_tpu_torch.convert.u2net_import import convert_u2net
        from diffsim_tpu_torch.models.u2net import U2NetConfig

        sd = _load(args.model)
        # the lite checkpoint (u2netp.pth) has 16-channel mids: told apart by stage1's
        lite = np.asarray(sd["stage1.rebnconv1.conv_s1.weight"]).shape[0] == 16
        tree = convert_u2net(sd, U2NetConfig.u2netp() if lite else U2NetConfig.u2net())
    else:
        from diffsim_tpu_torch.convert.sam_import import convert_sam
        from diffsim_tpu_torch.models.sam import SamConfig

        sd = _load(args.model)
        # the variant from the encoder width
        dim = np.asarray(sd["image_encoder.patch_embed.proj.weight"]).shape[0]
        cfg = {768: SamConfig.vit_b, 1024: SamConfig.vit_l, 1280: SamConfig.vit_h}[dim]()
        tree = convert_sam(sd, cfg)

    tree = DI.cast_tree(tree, dtype)
    save_params(args.out, tree)
    n = sum(x.size for x in _flatten(tree).values())
    print(f"wrote {args.out}: {n / 1e6:.1f}M params as {args.dtype}")


if __name__ == "__main__":
    main()
