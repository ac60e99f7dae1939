"""The ``--bf16_softmax`` fast mode of the PyTorch port on the CPU: the ``bf16_probs`` plain
versions of K1 and K4 against the JAX package's Pallas kernels in interpret mode, the fast math
path of ``sdpa`` against JAX's under ``fast_softmax``, and ``DiffSimSD15(fast_softmax=True)``
against the JAX scorer's fast mode on bridged weights with injected noise. The CUDA kernels'
fast mode runs only on the card (chip_smoke.py holds it to these plain versions there).

Where XLA's CPU compiler rounds: it computes the TPU kernels' bf16 arithmetic in float32 with
the rounding steps the program spells out, and (excess precision being allowed) drops a
rounding whose value goes straight back to float32, such as the exponentials fed to a float32
sum. The plain versions follow it op for op (their docstrings say where), so the limits below
are float32 summation-order limits, not bf16 ones. The kernel tests draw Q and K on a grid of
multiples of 1/8 (1/32 for K4), so that every logit is exact in float32 whatever order the two
frameworks sum it in: a one-ulp difference of a logit could otherwise flip the bf16 rounding of
its centred value and move one probability by 2^-8 relative (1.3e-3 on an output, measured),
which would hide the rounding steps under test behind a loose limit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from diffsim_tpu.ops import attention as jattn
from diffsim_tpu.ops.pallas import attention as pattn
from diffsim_tpu.ops.pallas import attention_stream as pstream
from diffsim_tpu_torch.ops import attention as tattn
from diffsim_tpu_torch.ops import kernels
from diffsim_tpu_torch.ops.kernels.attention import fused_self_attention, fused_self_attention_plain
from diffsim_tpu_torch.ops.kernels.attention_stream import (
    streaming_self_attention,
    streaming_self_attention_plain,
)
from tests.test_torch_port_scorer import _inputs, _jax, _port, fix  # noqa: F401

# the kernels and the math path on exact logits: float32 summation order of the row sums and of
# P V, and the two libraries' float32 exp; bf16 outputs of the math path may differ by the one
# bf16 ulp that the P V order can flip
ATOL = 1e-5
# a row sum rounded to bf16 can still flip with the float32 order of its terms, which scales
# that row's output by 1 +- 2^-8: such rows pass within RTOL, and they may be at most
# FLIP_SHARE of the elements (a missing or misplaced rounding would move most of them)
RTOL = 2.0**-7
FLIP_SHARE = 0.01
# scores on bridged weights, cosine and mse: the gap to the JAX scorer's fast mode (measured
# <= 2.2e-6) must stay below this and below a third of the gap to the exact mode (>= 6.9e-6)
SCORE_ATOL = 5e-6


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _grid(shape, seed, step=1 / 8):
    """Multiples of ``step`` in [-16 step, 16 step]: products and sums of a logit are exact."""
    return (np.random.default_rng(seed).integers(-16, 17, shape) * step).astype(np.float32)


def _assert_close(out, ref):
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    assert np.mean(np.abs(out - ref) > ATOL) <= FLIP_SHARE


@pytest.mark.parametrize("s", [256, 512])
@pytest.mark.parametrize("d", [40, 80, 160])
def test_k1_bf16_probs_plain_matches_pallas_interpret(s, d):
    q, k = (_grid((1, 2, s, d), seed) for seed in range(2))
    v = _rand((1, 2, s, d), 2)
    with pltpu.force_tpu_interpret_mode():
        ref = pattn.fused_self_attention(*(jnp.asarray(a) for a in (q, k, v)), bf16_probs=True)
        exact = pattn.fused_self_attention(*(jnp.asarray(a) for a in (q, k, v)))
    out = fused_self_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), bf16_probs=True)
    _assert_close(out.numpy(), np.asarray(ref))
    assert np.abs(np.asarray(ref) - np.asarray(exact)).max() > 10 * ATOL  # a distinct mode


@pytest.mark.parametrize("s, d", [(2048, 256), (1024, 512)])
def test_k4_bf16_probs_plain_matches_pallas_interpret(s, d):
    """The shape of the JAX package's own test of the mode (tests/test_pallas_kernels.py):
    several key blocks, so the online recurrence and its per-block rounding are exercised."""
    q, k = (_grid((1, 1, s, d), seed, 1 / 32) for seed in range(2))
    v = _rand((1, 1, s, d), 2, 0.3)
    with pltpu.force_tpu_interpret_mode():
        ref = pstream.streaming_self_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                               bf16_probs=True)
    out = streaming_self_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                         bf16_probs=True)
    _assert_close(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape", [(2, 3, 16, 8), (1, 2, 64, 40), (2, 2, 1, 8, 256, 160)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_fast_math_path_matches_jax(shape, dtype):
    """The math path (here: 4-D sites below K1's 256 tokens, and the readout's 5-D taps) in
    fast mode normalises before P V with the weights cast to V's dtype."""
    q, k = (_grid(shape, seed) for seed in range(2))
    v = _rand(shape, 2)

    def fast(q, k, v):
        with jattn.fast_softmax(True):
            return jattn.sdpa(q, k, v)

    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(jax.jit(fast)(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
                     .astype(jnp.float32))
    args = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    with tattn.fast_softmax():
        out = tattn.sdpa(*args).float().numpy()
    rtol = 2.0**-7 if dtype == "bfloat16" else 0.0
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=rtol)
    assert not np.array_equal(out, tattn.sdpa(*args).float().numpy())  # the flag is read per call


def test_fast_softmax_routes_the_kernels_mode():
    """Inside fast_softmax, sdpa passes bf16_probs to the kernels (K1 at >= 256 tokens, K4 at
    >= 8192 tokens of a wide head); the context is left as it was afterwards."""
    q, k, v = (torch.from_numpy(_rand((1, 2, 256, 40), seed)) for seed in range(3))
    with tattn.fast_softmax():
        assert tattn.fast_softmax_enabled()
        assert torch.equal(tattn.sdpa(q, k, v), fused_self_attention(q, k, v, True))
    assert not tattn.fast_softmax_enabled()
    assert torch.equal(tattn.sdpa(q, k, v), fused_self_attention(q, k, v))
    q, k, v = (torch.from_numpy(_rand((1, 1, 8192, 192), seed, 0.3)) for seed in range(3))
    with tattn.fast_softmax():
        assert torch.equal(tattn.sdpa(q, k, v), streaming_self_attention(q, k, v, True))
    # CPU tensors take the plain versions: no launch is counted in either mode
    assert kernels.bf16_probs_launch_counts() == {"fused_self_attention": 0,
                                                  "streaming_self_attention": 0}


@pytest.mark.parametrize("similarity", ["cosine", "mse"])
def test_score_batch_fast_matches_jax(fix, similarity):  # noqa: F811
    """The pair path runs its whole graph in fast mode, the VAE included. On the CPU the JAX
    scorer takes its math path at the 256-token sites of the tiny models, where the port takes
    K1's plain version, so both of its contracts meet here."""
    params = fix[1]
    a, b, noise = _inputs(3, np.uint8)
    kw = dict(prompt="a photo of a dog", target_block="up_blocks", target_layer=(0,),
              target_step=600, similarity=similarity, noise_override=noise)
    ref = _jax(params, fast_softmax=True).score_batch(a, b, **kw)
    out = _port(params, fast_softmax=True).score_batch(a, b, **kw)
    exact = _port(params).score_batch(a, b, **kw)
    np.testing.assert_allclose(out, ref, atol=SCORE_ATOL)
    assert np.abs(out - ref).max() < np.abs(out - exact).max() / 3


def test_triplet_paths_keep_the_encode_exact(fix, tmp_path):  # noqa: F811
    """The triplet and cached paths run only the tail in fast mode: the moment pool of a fast
    scorer equals an exact scorer's bit for bit, and its scores differ from the exact ones."""
    from PIL import Image

    rng = np.random.default_rng(7)
    paths = []
    for i in range(6):
        paths.append(str(tmp_path / f"im{i}.png"))
        Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(paths[-1])
    roles = paths[0:2], paths[2:4], paths[4:6]
    fast, exact = _port(fix[1], fast_softmax=True), _port(fix[1])
    f_ab, f_ac = fast.score_triplet_paths(*roles, prompt="p", target_layer=(0,))
    e_ab, e_ac = exact.score_triplet_paths(*roles, prompt="p", target_layer=(0,))
    assert torch.equal(fast._moment_cache.pool, exact._moment_cache.pool)
    assert not (np.array_equal(f_ab, e_ab) and np.array_equal(f_ac, e_ac))
