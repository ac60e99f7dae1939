"""K4 at the widths past 512 and at float32's D % 64 != 0, on the CPU.

``csrc/streaming_attention_wide.cu`` takes every head that ``routes.use_streaming`` admits
beyond what ``csrc/streaming_attention.cu`` takes: 512 < D <= 1024 in both dtypes, and float32
at D % 64 != 0. Its CUDA kernels run only on the card (``chip_smoke.py``'s "K4 wide heads"
phase holds them to the plain version there). Here: the plain version against the JAX package's
Pallas kernel in interpret mode at D 576 and 1024 (float32, bf16, the bf16_probs mode); the
route against JAX's at those widths; the wrapper's choice of library; the widened VAE encoder
(last block 576 wide) against JAX's on bridged weights; and the wide float32 kernel's arithmetic
repeated in torch (3xTF32, a fresh truncating tensor-core sum for each 64-column chunk of Q K^T,
16 of them a score at D = 1024, and for each 8-key chunk of P V), held to the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsim_tpu.models import vae as jvae
from diffsim_tpu.ops.pallas import attention as pattn
from diffsim_tpu.ops.pallas import attention_stream as pstream
from diffsim_tpu_torch.metrics.scorer_base import build_module
from diffsim_tpu_torch.models.vae import Encoder, VAEConfig, encode_chunked
from diffsim_tpu_torch.ops import attention as tattn
from diffsim_tpu_torch.ops.kernels import routes
from diffsim_tpu_torch.ops.kernels.attention_stream import (
    MAX_DIM,
    library_name,
    streaming_self_attention_plain,
)
from tests.test_torch_port_k1_tf32x3 import mma_sum, passes_of

ATOL = 3e-5  # float32 plain version against the Pallas kernel in interpret mode
CARD_ATOL = 1e-5  # chip_smoke.py's float32 limit for K4 against its plain version
BF16_ULP = 2.0**-8  # a bf16 rounding, relative, at most
WIDE = (576, 1024)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small matrix products run faster on one intra-op thread than on many, most of all while
    the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _grid(shape, seed, step=1 / 32):
    """Multiples of ``step`` in [-16 step, 16 step]: products and sums of a logit are exact."""
    return (np.random.default_rng(seed).integers(-16, 17, shape) * step).astype(np.float32)


def _pallas(monkeypatch, q, k, v, dtype=jnp.float32, bf16_probs=False):
    monkeypatch.setenv("DIFFSIM_TPU_PALLAS_INTERPRET", "1")
    out = pstream.streaming_self_attention(*(jnp.asarray(a).astype(dtype) for a in (q, k, v)),
                                           bf16_probs=bf16_probs)
    return np.array(out.astype(jnp.float32))


@pytest.mark.parametrize("d", WIDE)
def test_k4_plain_matches_pallas_interpret_past_512(monkeypatch, d):
    q, k, v = (_rand((1, 1, 512, d), seed, 0.3) for seed in range(3))
    ref = _pallas(monkeypatch, q, k, v)
    out = streaming_self_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("d", WIDE)
def test_k4_bf16_plain_matches_pallas_interpret_past_512(monkeypatch, d):
    """bf16 q, k, v: both take float32 logits and cast the probabilities to bf16 for P V, the
    Pallas kernel against each 256-key block's running max, the plain version against the row's
    max. So each probability's rounding may differ (2^-8 of its share of |V|), and each output's
    rounding to bf16 (2^-8 of it, in each of the two)."""
    q, k, v = (_rand((1, 1, 512, d), seed, 0.3) for seed in range(3, 6))
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    ref = _pallas(monkeypatch, q, k, v, jnp.bfloat16)
    out = streaming_self_attention_plain(*bf)
    assert out.dtype == torch.bfloat16
    qd, kd, vd = (t.double() for t in bf)
    w = torch.softmax((qd @ kd.transpose(-1, -2)) * d**-0.5, dim=-1)
    limit = BF16_ULP * (w @ vd.abs()) + 2 * BF16_ULP * torch.from_numpy(ref).double().abs()
    err = (out.double() - torch.from_numpy(ref).double()).abs()
    assert (err <= limit).all(), (err - limit).max().item()


@pytest.mark.parametrize("d", WIDE)
def test_k4_bf16_probs_plain_matches_pallas_interpret_past_512(monkeypatch, d):
    """The fast mode as ``tests/test_torch_port_fast.py`` holds it at D 256 and 512: logits
    exact in float32 (Q and K on a 1/32 grid), so the two agree within float32 summation order,
    and a row sum's bf16 rounding may flip with that order (that row within 2^-7) on at most 1 %
    of the elements; the mode differs from the exact one."""
    q, k = (_grid((1, 1, 512, d), seed) for seed in range(6, 8))
    v = _rand((1, 1, 512, d), 8, 0.3)
    ref = _pallas(monkeypatch, q, k, v, bf16_probs=True)
    out = streaming_self_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                         bf16_probs=True).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=2.0**-7)
    assert np.mean(np.abs(out - ref) > 1e-5) <= 0.01
    exact = _pallas(monkeypatch, q, k, v)
    assert np.abs(ref - exact).max() > 10 * 1e-5


@pytest.fixture
def jax_routes_everywhere(monkeypatch):
    """The JAX predicates with their platform gate open, leaving only their shape parts."""
    monkeypatch.setattr(pattn, "pallas_route", lambda batch0: True)


@pytest.mark.parametrize("d", [520, 768, 1024, 1032, 168, 200, 328])
@pytest.mark.parametrize("s", [8192, 16384])
def test_streaming_route_predicate_matches_jax_at_wide_heads(jax_routes_everywhere, s, d):
    q_shape = (2, 1, s, d)
    assert routes.use_streaming(q_shape, q_shape) == pstream.use_streaming(q_shape, q_shape)
    assert routes.use_streaming(q_shape, q_shape) == (d <= MAX_DIM)


@pytest.mark.parametrize("d", [200, 576, 768, 1024])
def test_wide_heads_reach_the_kernel_wrapper_off_the_cpu(d):
    """Off the CPU the wide heads go to K4's wrapper, which launches on CUDA and refuses any
    other device (meta tensors stand in for CUDA ones here)."""
    t = torch.empty((2, 1, 16384, d), device="meta")
    with pytest.raises(ValueError, match="streaming_self_attention: unsupported device"):
        tattn.sdpa(t, t, t)


@pytest.mark.parametrize("d, dtype, name", [
    (512, torch.float32, "streaming_attention"), (512, torch.bfloat16, "streaming_attention"),
    (168, torch.bfloat16, "streaming_attention"), (448, torch.float32, "streaming_attention"),
    (168, torch.float32, "streaming_attention_wide"),
    (200, torch.float32, "streaming_attention_wide"),
    (520, torch.bfloat16, "streaming_attention_wide"),
    (1024, torch.float32, "streaming_attention_wide"),
    (1024, torch.bfloat16, "streaming_attention_wide"),
])
def test_each_width_goes_to_the_library_whose_kernel_takes_it(d, dtype, name):
    assert library_name(d, dtype) == name


def _redrawn(tree, seed):
    """A JAX init tree with every leaf redrawn N(0, 0.1) from ``seed`` (numpy)."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(jax.device_get(tree))
    return jax.tree_util.tree_unflatten(
        treedef, [(rng.standard_normal(np.shape(x)) * 0.1).astype(np.float32) for x in leaves])


def test_widened_encoder_matches_jax_on_bridged_weights():
    """A VAE encoder whose last block is 576 wide (so its mid attention has D = 576, as the
    1024-wide one that chip_smoke.py drives through K4 at 1024 px has D = 1024), on 64 x 64
    images in slices of one: the port's chunked encode against the JAX one on the same weights
    carried across by the bridge. At 256 tokens both take the math path."""
    widths = dict(block_out_channels=(32, 64, 576), layers_per_block=1)
    params = _redrawn(jvae.encoder_init(jax.random.PRNGKey(0), jvae.VAEConfig(**widths)), 9)
    pix = np.random.default_rng(10).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jvae.encoder_apply_chunked(params, jnp.asarray(pix), 1))
    model = build_module(lambda: Encoder(VAEConfig(**widths)), params, "vae",
                         torch.device("cpu"), torch.float32, None)
    with torch.no_grad():
        out = encode_chunked(model, torch.from_numpy(pix.transpose(0, 3, 1, 2).copy()), 1)
    assert model.mid.attn.to_q.weight.shape == (576, 576)
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), ref, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the wide float32 kernel's arithmetic (csrc/streaming_attention_wide.cu stream_f32_wide)
# ---------------------------------------------------------------------------

KEYS, DC, VC = 64, 64, 8  # keys a tile, columns of a Q K^T chunk, keys of a P V chunk


def emulated_wide_f32(q, k, v, passes: int = 3):
    """stream_f32_wide in torch: per 64-key tile, each chunk of Q K^T over columns [64 c, 64 c +
    64) cut at D a fresh truncating tensor-core sum of ``passes`` TF32 products, the chunks added
    by rounded float32 adds; the online softmax in float32 (the max over the unscaled scores,
    exp((s - m) scale), l = l corr + the tile's sum); the accumulator rescaled by corr, then each
    8-key chunk of P V a fresh truncating sum added by a rounded add; acc * (1 / l) last. The
    output columns' halves do the same arithmetic, so one pass over all of D stands for both."""
    s, d = q.shape[-2], q.shape[-1]
    scale = torch.tensor(d**-0.5, dtype=torch.float32)
    m = torch.full(q.shape[:-1] + (1,), -float("inf"))
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    zero = torch.zeros(q.shape[:-1] + (KEYS,))
    for j in range(0, s, KEYS):
        kt, vt = k[..., j:j + KEYS, :], v[..., j:j + KEYS, :]
        sc = None
        for c0 in range(0, d, DC):
            cols = slice(c0, c0 + DC)
            part = mma_sum(zero, *passes_of(q[..., cols], kt[..., cols].transpose(-1, -2),
                                            passes))
            sc = part if sc is None else sc + part
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        corr = torch.exp((m - m_new) * scale)
        p = torch.exp((sc - m_new) * scale)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr
        for k0 in range(0, KEYS, VC):
            keys = slice(k0, k0 + VC)
            acc = acc + mma_sum(torch.zeros_like(acc), *passes_of(p[..., keys], vt[..., keys, :],
                                                                  passes))
        m = m_new
    return acc * (1.0 / l)


@pytest.mark.parametrize("d", [1024, 200])
def test_wide_f32_arithmetic_stays_within_a_quarter_of_the_card_limit(d):
    """At D = 1024 a score is 16 chunk sums, at D = 200 three and a partial one of 8 columns;
    N(0, 1) inputs as chip_smoke.py draws them."""
    q, k, v = (torch.from_numpy(_rand((1, 1, 256, d), 11 + seed)) for seed in range(3))
    err = (emulated_wide_f32(q, k, v) - streaming_self_attention_plain(q, k, v)).abs().max()
    assert err.item() <= CARD_ATOL / 4, err.item()


def test_wide_f32_arithmetic_in_one_tf32_pass_misses_the_card_limit():
    q, k, v = (torch.from_numpy(_rand((1, 1, 256, 1024), 14 + seed)) for seed in range(3))
    err = (emulated_wide_f32(q, k, v, passes=1)
           - streaming_self_attention_plain(q, k, v)).abs().max()
    assert err.item() > CARD_ATOL, err.item()
