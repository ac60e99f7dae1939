"""Settings of the benchmark's own tests (``python -m pytest portbench/tests``): the ``card``
marker, for tests that need a CUDA card and skip without one, and tiny configurations of both
backbones for the CPU."""

import copy
import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(HERE))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


def _load(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def tiny_config(name: str) -> dict:
    """``configs/<name>.json`` at tiny widths and 32 px, in float32 throughout."""
    c = copy.deepcopy(_load(name))
    c["img_size"] = 32
    c["dtype"] = "float32"
    c["part_dtypes"] = {p: "float32" for p in c["part_dtypes"]}
    c["vae"].update(block_out_channels=[32, 64], layers_per_block=1)
    c["text"].update(vocab_size=1000, hidden=32, layers=2, heads=2, intermediate=64)
    if name == "sd15":
        c["unet"].update(block_out_channels=[32, 64], cross_attn_blocks=[True, False],
                         layers_per_block=1, transformer_depth=[1, 0], heads=[2, 2],
                         cross_attention_dim=32)
    else:
        c["unet"].update(block_out_channels=[32, 64], cross_attn_blocks=[False, True],
                         layers_per_block=1, transformer_depth=[0, 2], mid_transformer_depth=2,
                         heads=[2, 2], cross_attention_dim=64, addition_time_embed_dim=8,
                         projection_class_embeddings_input_dim=16 + 8 * 6)
        c["text2"].update(vocab_size=1000, hidden=32, layers=2, heads=2, intermediate=64,
                          projection_dim=16)
    return c


TINY_MIXES = {
    "triplet_reuse": {"kind": "triplet_reuse", "triplets": 3, "depth": 2, "new_share": 0.1,
                      "ring": 4, "warm_calls": 2},
    "serve_open": {"kind": "serve_open", "rate_per_s": 10.0, "pairs_per_request": [1, 2],
                   "block": 4, "pattern_seed": 0,
                   "max_batch": 4, "max_wait_ms": 5.0, "ring": 4, "warm_pairs": [1, 4]},
}


@pytest.fixture
def tiny():
    return tiny_config


@pytest.fixture
def tiny_mixes():
    return copy.deepcopy(TINY_MIXES)


@pytest.fixture
def bench():
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        return json.load(f)
