"""The PyTorch port's K3 (fused readout) and K4 (streaming attention) modules on the CPU: their
plain versions against the JAX package's Pallas kernels run as its own tests run them (K3 under
``pltpu.force_tpu_interpret_mode()``, K4 with ``DIFFSIM_TPU_PALLAS_INTERPRET=1``), the route
predicates against JAX's at the SDXL shapes, and the dispatch rules. The CUDA kernels run only
on the card (chip_smoke.py holds each against its plain version there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from diffsim_tpu.ops.pallas import attention as pattn
from diffsim_tpu.ops.pallas import attention_stream as pstream
from diffsim_tpu.ops.pallas import readout as pread
from diffsim_tpu_torch.metrics import readout as treadout
from diffsim_tpu_torch.ops import attention as tattn
from diffsim_tpu_torch.ops import kernels
from diffsim_tpu_torch.ops.kernels import routes
from diffsim_tpu_torch.ops.kernels.attention import fused_self_attention_plain
from diffsim_tpu_torch.ops.kernels.attention_stream import (
    streaming_self_attention,
    streaming_self_attention_plain,
)
from diffsim_tpu_torch.ops.kernels.readout import (
    cross_self_partials,
    cross_self_partials_plain,
    fused_direction_score,
    fused_direction_score_plain,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models run faster on one intra-op thread than on many, most of all while the
    suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("similarity", ["cosine", "mse"])
def test_k3_plain_matches_pallas_interpret(similarity):
    qa, ka, va, kb, vb = (_rand((2, 2, 2, 512, 32), seed) for seed in range(5))
    with pltpu.force_tpu_interpret_mode():
        ref = pread.fused_direction_score(*(jnp.asarray(a) for a in (qa, ka, va, kb, vb)),
                                          similarity)
    out = fused_direction_score_plain(*(torch.from_numpy(a) for a in (qa, ka, va, kb, vb)),
                                      similarity)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("mse", [False, True])
def test_k3_partials_match_pallas_interpret(mse):
    """The three per-row partial sums, before the per-pair epilogue."""
    q, k1, v1, k2, v2 = (_rand((3, 512, 16), seed, 0.5) for seed in range(5, 10))
    with pltpu.force_tpu_interpret_mode():
        ref = pread.cross_self_partials(*(jnp.asarray(a) for a in (q, k1, v1, k2, v2)), mse=mse)
    out = cross_self_partials_plain(*(torch.from_numpy(a) for a in (q, k1, v1, k2, v2)), mse=mse)
    for ours, theirs in zip(out, ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-5)


def test_k3_matches_the_math_readout():
    """At a routed tap the readout takes K3 in both directions; K3 equals the flattened cosine /
    MSE of the four attention outputs up to the order of the f32 sums."""
    qa, ka, va, qb, kb, vb = (torch.from_numpy(_rand((2, 2, 2, 512, 32), s)) for s in range(10, 16))
    assert routes.use_fused_readout(qa.shape)
    for similarity, flat in (("cosine", treadout._flat_cosine), ("mse", treadout._flat_mse)):
        fused = (fused_direction_score(qa, ka, va, kb, vb, similarity)
                 + fused_direction_score(qb, kb, vb, ka, va, similarity)) / 2
        full = treadout.cross_attention_score(qa, ka, va, qb, kb, vb, similarity)
        np.testing.assert_array_equal(full.numpy(), fused.numpy())
        math = (flat(tattn.sdpa(qa, kb, vb), tattn.sdpa(qa, ka, va))
                + flat(tattn.sdpa(qb, ka, va), tattn.sdpa(qb, kb, vb))) / 2
        np.testing.assert_allclose(full.numpy(), math.numpy(), rtol=1e-5, atol=1e-7)


def test_k4_plain_matches_pallas_interpret(monkeypatch):
    monkeypatch.setenv("DIFFSIM_TPU_PALLAS_INTERPRET", "1")
    q, k, v = (_rand((1, 1, 2048, 256), seed, 0.3) for seed in range(3))
    ref = pstream.streaming_self_attention(*(jnp.asarray(a) for a in (q, k, v)))
    out = streaming_self_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5)


def test_k4_plain_is_k1_plain_row_block_by_row_block():
    """The plain version takes the query rows in blocks only to bound its memory."""
    q, k, v = (torch.from_numpy(_rand((2, 1, 4352, 168), seed, 0.3)) for seed in range(3, 6))
    np.testing.assert_allclose(streaming_self_attention_plain(q, k, v).numpy(),
                               fused_self_attention_plain(q, k, v).numpy(), atol=1e-6)
    bf = [t.to(torch.bfloat16) for t in (q, k, v)]
    assert streaming_self_attention_plain(*bf).dtype == torch.bfloat16


@pytest.fixture
def jax_routes_everywhere(monkeypatch):
    """The JAX predicates with their platform gate open, leaving only their shape parts."""
    monkeypatch.setattr(pattn, "pallas_route", lambda batch0: True)


@pytest.mark.parametrize("q_shape", [
    (2, 1, 16384, 512), (6, 1, 16384, 512), (1, 1, 8448, 512), (1, 1, 8192, 160),
    (1, 1, 16384, 256), (1, 1, 8200, 512), (1, 1, 4096, 512), (1, 1, 16384, 1032),
])
def test_streaming_route_predicate_matches_jax_at_vae_shapes(jax_routes_everywhere, q_shape):
    assert routes.use_streaming(q_shape, q_shape) == pstream.use_streaming(q_shape, q_shape)


@pytest.mark.parametrize("q_shape", [
    (2, 2, 20, 1024, 64), (2, 2, 10, 4096, 64), (1, 2, 2, 4096, 32), (2, 2, 16, 1024, 72),
    (1, 2, 8, 4096, 40), (2, 2, 2, 1024, 32), (2, 2, 20, 256, 64), (2, 2, 2, 768, 32),
])
def test_readout_route_predicate_matches_jax_at_xl_taps(jax_routes_everywhere, q_shape):
    assert routes.use_fused_readout(q_shape) == pread.use_fused_readout(q_shape)


def test_cpu_tensors_take_the_plain_versions_without_counting_launches():
    kernels.reset_launch_counts()
    rows = [torch.from_numpy(_rand((2, 512, 16), s)) for s in range(20, 25)]
    for mse in (False, True):
        for ours, plain in zip(cross_self_partials(*rows, mse=mse),
                               cross_self_partials_plain(*rows, mse=mse)):
            assert torch.equal(ours, plain)
    q = torch.from_numpy(_rand((1, 1, 512, 192), 25))
    assert torch.equal(streaming_self_attention(q, q, q), streaming_self_attention_plain(q, q, q))
    assert set(kernels.launch_counts()) == {"fused_self_attention", "fused_geglu_ff",
                                            "cross_self_partials", "streaming_self_attention",
                                            "fused_self_attention_bwd"}
    assert not any(kernels.launch_counts().values())


def _meta(shape):
    return torch.empty(shape, device="meta")


def test_routed_shapes_reach_the_kernel_wrappers_off_the_cpu():
    """Off the CPU the K4 and K3 shapes go to their kernels' wrappers, which launch on CUDA and
    refuse any other device (meta tensors stand in for CUDA ones here)."""
    big = _meta((1, 1, 16384, 512))
    with pytest.raises(ValueError, match="streaming_self_attention: unsupported device"):
        tattn.sdpa(big, big, big)
    tap = _meta((1, 2, 20, 1024, 64))
    with pytest.raises(ValueError, match="cross_self_partials: unsupported device"):
        treadout.cross_attention_score(tap, tap, tap, tap, tap, tap)
