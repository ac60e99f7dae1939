"""The PyTorch port's kernel modules on the CPU: the plain versions of K1 and K2 against the
JAX package's Pallas kernels run in interpret mode (as tests/test_pallas_kernels.py runs them),
the route predicates against JAX's, and the dispatch rules. The CUDA kernels themselves run only
on the card (chip_smoke.py holds each against its plain version there)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from diffsim_tpu.ops.pallas import attention as pattn
from diffsim_tpu.ops.pallas import attention_stream as pstream
from diffsim_tpu.ops.pallas import ff as pff
from diffsim_tpu.ops.pallas import readout as pread
from diffsim_tpu_torch.metrics import readout as treadout
from diffsim_tpu_torch.ops import attention as tattn
from diffsim_tpu_torch.ops import kernels
from diffsim_tpu_torch.ops.kernels import build, routes
from diffsim_tpu_torch.ops.kernels.attention import fused_self_attention, fused_self_attention_plain
from diffsim_tpu_torch.ops.kernels.ff import fused_geglu_ff, fused_geglu_ff_plain

ATOL = 2e-5


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("s", [256, 512])
@pytest.mark.parametrize("d", [40, 80, 160])
def test_k1_plain_matches_pallas_interpret(s, d):
    q, k, v = (_rand((1, 2, s, d), seed) for seed in range(3))
    with pltpu.force_tpu_interpret_mode():
        ref = pattn.fused_self_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = fused_self_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("c", [32, 64])
def test_k2_plain_matches_pallas_interpret(c):
    n = 512
    x = _rand((n, c), 3)
    w1, b1 = _rand((c, 8 * c), 4, c**-0.5), _rand((8 * c,), 5, 0.1)
    w2, b2 = _rand((4 * c, c), 6, (4 * c) ** -0.5), _rand((c,), 7, 0.1)
    with pltpu.force_tpu_interpret_mode():
        ref = pff.fused_geglu_ff(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)),
                                 block_rows=pff._block_rows(n, c))
    # the port keeps the nn.Linear (out, in) layout: W1 (8C, C), W2 (C, 4C)
    out = fused_geglu_ff_plain(torch.from_numpy(x), torch.from_numpy(w1.T.copy()),
                               torch.from_numpy(b1), torch.from_numpy(w2.T.copy()),
                               torch.from_numpy(b2))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_versions_keep_the_value_dtype(dtype):
    q = torch.from_numpy(_rand((1, 1, 256, 16), 8)).to(dtype)
    assert fused_self_attention_plain(q, q, q).dtype == dtype
    x = torch.from_numpy(_rand((8, 32), 9)).to(dtype)
    w1, b1 = torch.zeros(256, 32, dtype=dtype), torch.zeros(256, dtype=dtype)
    w2, b2 = torch.zeros(32, 128, dtype=dtype), torch.ones(32, dtype=dtype)
    out = fused_geglu_ff_plain(x, w1, b1, w2, b2)
    assert out.dtype == dtype and torch.equal(out, torch.ones_like(out))


def test_cpu_tensors_take_the_plain_versions_without_counting_launches():
    kernels.reset_launch_counts()
    q, k, v = (torch.from_numpy(_rand((2, 2, 256, 24), s)) for s in (10, 11, 12))
    assert torch.equal(fused_self_attention(q, k, v), fused_self_attention_plain(q, k, v))
    x = torch.from_numpy(_rand((64, 32), 13))
    w = [torch.from_numpy(_rand(sh, 14 + i)) for i, sh in
         enumerate([(256, 32), (256,), (32, 128), (32,)])]
    assert torch.equal(fused_geglu_ff(x, *w), fused_geglu_ff_plain(x, *w))
    assert kernels.launch_counts() == {"fused_self_attention": 0, "fused_geglu_ff": 0,
                                       "cross_self_partials": 0, "streaming_self_attention": 0,
                                       "fused_self_attention_bwd": 0}


ATTN_SHAPES = [
    ((4, 8, 4096, 40), (4, 8, 4096, 40)),
    ((4, 8, 4096, 40), (4, 8, 77, 40)),
    ((4, 8, 256, 40), (4, 8, 256, 40)),
    ((4, 8, 256, 160), (4, 8, 256, 160)),
    ((4, 8, 64, 160), (4, 8, 64, 160)),
    ((4, 8, 1280, 64), (4, 8, 1280, 64)),
    ((4, 8, 1000, 64), (4, 8, 1000, 64)),
    ((4, 8, 1024, 168), (4, 8, 1024, 168)),
    ((16, 1, 4096, 512), (16, 1, 4096, 512)),
    ((2, 1, 16384, 512), (2, 1, 16384, 512)),
    ((2, 1, 8192, 160), (2, 1, 8192, 160)),
    ((2, 1, 8192, 2048), (2, 1, 8192, 2048)),
]


@pytest.fixture
def jax_routes_everywhere(monkeypatch):
    """The JAX predicates with their platform gate open, leaving only their shape parts."""
    monkeypatch.setattr(pattn, "pallas_route", lambda batch0: True)


@pytest.mark.parametrize("q_shape,k_shape", ATTN_SHAPES)
def test_attention_route_predicates_match_jax(jax_routes_everywhere, q_shape, k_shape):
    assert routes.use_fused(q_shape, k_shape) == pattn.use_fused(q_shape, k_shape)
    assert routes.use_streaming(q_shape, k_shape) == pstream.use_streaming(q_shape, k_shape)


@pytest.mark.parametrize("n,c,w1_cols", [
    (24 * 4096, 320, 2560), (24 * 1024, 640, 5120), (24 * 256, 1280, 10240), (512, 32, 256),
    (20, 32, 256), (8, 32, 256), (4, 32, 256), (512, 32, 128), (12 * 4096, 641, 5128),
])
def test_ff_route_predicate_matches_jax(jax_routes_everywhere, n, c, w1_cols):
    assert routes.use_fused_ff(n, c, w1_cols) == pff.use_fused_ff(n, c, w1_cols)


@pytest.mark.parametrize("q_shape", [
    (4, 2, 8, 256, 160), (4, 2, 8, 1024, 80), (4, 2, 8, 4096, 40), (2, 2, 10, 4096, 64),
    (2, 2, 8, 1536, 64), (2, 2, 8, 1024, 160), (2, 2, 8, 77, 80), (2, 2, 16, 1024, 72),
])
def test_readout_route_predicate_matches_jax(jax_routes_everywhere, q_shape):
    assert routes.use_fused_readout(q_shape) == pread.use_fused_readout(q_shape)


def _meta(shape):
    return torch.empty(shape, device="meta")


def test_unported_kernels_raise_off_the_cpu():
    """Off the CPU, a routed shape never quietly takes the math path: it reaches its kernel's
    wrapper (K3, K4 included, now ported), which launches on CUDA and raises on any other
    device (meta tensors stand in for CUDA ones here)."""
    big = _meta((1, 1, 16384, 512))
    with pytest.raises(ValueError, match="streaming_self_attention: unsupported device"):
        tattn.sdpa(big, big, big)
    tap = _meta((1, 2, 8, 1024, 80))
    with pytest.raises(ValueError, match="cross_self_partials: unsupported device"):
        treadout.cross_attention_score(tap, tap, tap, tap, tap, tap)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_self_attention(_meta((1, 1, 256, 40)), _meta((1, 1, 256, 40)),
                             _meta((1, 1, 256, 40)))
    with pytest.raises(ValueError, match="unsupported device"):
        fused_geglu_ff(_meta((64, 32)), _meta((256, 32)), _meta((256,)), _meta((32, 128)),
                       _meta((32,)))


def test_every_kernel_source_is_present():
    for name in build.SOURCES + build.BASELINES:
        path = os.path.join(build.CSRC_DIR, f"{name}.cu")
        with open(path) as f:
            src = f.read()
        assert 'extern "C"' in src and "kernel_error_string" in src, path
