"""CLI argument surface of the port (the port's copy of ``diffsim_tpu/cli/args.py``): the
reference's argprocess flags plus the framework's batching, weights, cache and resume flags.
The device is not a flag: the CLI scores on the card."""

from __future__ import annotations

import argparse
import sys

# The reference's per-benchmark hyperparameters, verbatim from its launcher scripts (the
# JAX package's PRESETS). ``--preset X`` expands to these flags; any flag the user passes
# explicitly wins (presets are prepended, argparse keeps the last occurrence).
PRESETS = {
    "cute": "--image_size 512 --target_block up_blocks --target_layer 0 --target_step 600"
            " --similarity cosine --seed 2334 --metric diffsim",
    "nights": "--image_size 512 --target_block up_blocks --target_layer 0 --target_step 500"
              " --similarity cosine --seed 2334 --metric diffsim",
    "sref": "--target_block up_blocks --target_layer 0 --target_step 900"
            " --similarity cosine --seed 2334 --metric diffsim",
    "instantstyle": "--target_block up_blocks --target_layer 0 --target_step 900"
                    " --similarity cosine --seed 2334 --metric diffsim",
    "tid": "--target_block up_blocks --target_layer 0 --target_step 900"
           " --similarity cosine --seed 2334 --metric diffsim",
    "ipref": "--target_block up_blocks --target_layer 5 --target_step 750"
             " --similarity cosine --seed 2334 --metric diffsim",
    "dreambench": "--target_block up_blocks --target_layer 0 --target_step 750"
                  " --similarity cosine --seed 2334 --metric diffsim",
}


def expand_preset(argv):
    """Replace ``--preset NAME`` with the canonical reference flag set (prepended, so explicit
    flags in argv override the preset's values)."""
    argv = list(argv)
    if "--preset" not in argv:
        return argv
    i = argv.index("--preset")
    try:
        name = argv[i + 1]
    except IndexError:
        raise SystemExit("--preset requires a name: " + "|".join(sorted(PRESETS)))
    if name not in PRESETS:
        raise SystemExit(f"unknown preset {name!r}; choose from {'|'.join(sorted(PRESETS))}")
    del argv[i:i + 2]
    return PRESETS[name].split() + argv


def arg_parse(argv=None):
    argv = expand_preset(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(description="diffsim-tpu 2AFC benchmark CLI (PyTorch/CUDA)")
    parser.add_argument("--preset", type=str, choices=sorted(PRESETS), default=None,
                        help="Expand the reference's flag set for a benchmark (consumed before "
                             "parsing; explicit flags override)")
    # --- reference-compatible surface ---
    parser.add_argument("--image_path", type=str, help="Path to image folder")
    parser.add_argument("--original_path", type=str, default=None,
                        help="Path to original images for ipref")
    parser.add_argument("--out_path", type=str, default=None,
                        help="Output folder / results JSONL path")
    parser.add_argument("--image_size", type=int, default=512)
    parser.add_argument("--target_block", type=str,
                        choices=["down_blocks", "mid_blocks", "up_blocks"], default="up_blocks")
    parser.add_argument("--target_layer", type=int, default=[2], nargs="+",
                        help="Target layer index; 3 numbers (block, attention, transformer) "
                             "for SDXL")
    parser.add_argument("--target_step", type=int, default=100)
    parser.add_argument("--metric", type=str, default="diffsim",
                        choices=["diffsim", "diffsim_xl", "clip_i", "clip_cross", "dino",
                                 "dinov1", "dino_cross", "cute", "lpips", "gram", "diffeats",
                                 "clipfeats", "dinofeats", "ensemble", "dit"],
                        help="diffsim (SD-1.5), diffeats, diffsim_xl (SDXL), dit (DiT-XL/2), "
                             "the baselines, and ensemble (diffsim, clip_i and dino voting)")
    parser.add_argument("--similarity", type=str, choices=["cosine", "mse"], default="mse")
    parser.add_argument("--prompt", type=str, default="High quality image")
    parser.add_argument("--ip_adapter", action="store_true",
                        help="Tap attn2's IP-Adapter keys and values (diffsim, diffsim_xl); the "
                             "adapter tokens come from the scored images")
    parser.add_argument("--use_mask", action="store_true",
                        help="Weight the tapped queries by foreground masks (diffsim): from "
                             "--mask_path when given, else made at score time: SAM with "
                             "--sam_weights, U^2-Net saliency with --matting_weights, the "
                             "border-statistics heuristic otherwise")
    parser.add_argument("--mask_path", type=str, default=None,
                        help="Root of a tree mirroring --image_path with one grayscale mask "
                             "per image (same relative path, or its stem with .png)")
    parser.add_argument("--use_text_attn", action="store_true",
                        help="Tap the text cross-attention (attn2) Q/K/V instead of the "
                             "self-attention, with the same readout")
    parser.add_argument("--seed", type=int, default=2333)
    # --- framework extensions ---
    parser.add_argument("--batch_size", type=int, default=16,
                        help="Comparisons per scoring call; a call that would not fit the "
                             "card's memory is split into chunks that do")
    parser.add_argument("--weights", type=str, default=None, help="Converted checkpoint (.npz)")
    parser.add_argument("--ip_weights", type=str, default=None,
                        help="Converted IP-Adapter .npz (convert_ip_adapter's tree); the image "
                             "encoder stays random, as in the JAX CLI")
    parser.add_argument("--matting_weights", type=str, default=None,
                        help="Converted U^2-Net .npz (cli.convert u2net): the mattes of "
                             "--metric cute and the masks of --use_mask; the heuristic otherwise")
    parser.add_argument("--sam_weights", type=str, default=None,
                        help="Converted SAM .npz (cli.convert sam): --use_mask makes its masks "
                             "with a centre-point SAM prompt; takes precedence over "
                             "--matting_weights")
    parser.add_argument("--tokenizer_dir", type=str, default=None,
                        help="Dir with vocab.json + merges.txt")
    parser.add_argument("--allow_hash_tokenizer", action="store_true",
                        help="Permit --weights without --tokenizer_dir (hash-tokenized prompts "
                             "make converted-weight scores meaningless; throughput runs only)")
    parser.add_argument("--results", type=str, default=None,
                        help="JSONL results path (enables resume)")
    parser.add_argument("--no_cfg_parity", dest="cfg_parity", action="store_false",
                        help="Drop the CFG uncond half (half the UNet rows, not score-parity "
                             "with the reference)")
    parser.add_argument("--fast_decode", action="store_true",
                        help="Decode large JPEGs in the DCT domain at >= image_size per side "
                             "before the lanczos resize: faster host decode, pixels differ "
                             "slightly from the reference's full-resolution decode")
    parser.add_argument("--bf16_softmax", action="store_true",
                        help="Fast mode: attention probabilities in bfloat16 (the kernels' "
                             "bf16_probs mode). Not parity with the float32 softmax; its cost "
                             "or saving on the card is in PERF.md")
    parser.add_argument("--xl_vae_bf16", action="store_true",
                        help="SDXL: encode with a bf16 VAE instead of the reference's float32 "
                             "(not bit-parity with the reference)")
    parser.add_argument("--no_device_cache", dest="device_cache", action="store_false",
                        help="Disable the device moment cache: every call decodes, uploads and "
                             "encodes its pixels, as the reference does")
    parser.add_argument("--moment_cache_mb", type=float, default=None,
                        help="Device memory for the moment cache in MB (default 512: ~64 KB an "
                             "image at 512 px in bf16)")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="Only 1 (or unset): multi-GPU scoring is not ported yet")
    parser.add_argument("--shard", type=str, default=None, metavar="I/N",
                        help="Run only comparison slice I of N (e.g. 0/4); the per-shard JSONL "
                             "results (--results r.jsonl becomes r.jsonl.sI-N) merge by "
                             "concatenation")
    parser.add_argument("--model_scale", type=str, choices=["full", "tiny"], default="full",
                        help="'tiny' uses toy model configs (CPU tests)")
    parser.add_argument("--profile", action="store_true",
                        help="Print a per-stage time breakdown")
    parser.add_argument("--profile_trace", type=str, default=None,
                        help="Directory for a torch.profiler Chrome trace of the run")
    return parser.parse_args(argv)
