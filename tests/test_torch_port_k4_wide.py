"""K4 at the widths past 512, at float32's D % 64 != 0 and at D % 8 != 0, on the CPU.

``csrc/streaming_attention_wide.cu`` takes every head that ``routes.use_streaming`` admits
beyond what ``csrc/streaming_attention.cu`` takes: 512 < D <= 1024 in both dtypes, and float32
at D % 64 != 0, a 2-block cluster a q block whose blocks each take a share of D and exchange their
partial scores. Its CUDA kernels run only on the card (``chip_smoke.py``'s "K4 wide heads" phase
holds them to the plain version there). Here: the plain version against the JAX package's Pallas
kernel in interpret mode at D 576 and 1024 (float32, bf16, the bf16_probs mode); the route
against JAX's at those widths; the wrapper's choice of library, its zero padding of D % 8 != 0
(D 170 and 1020: the padded plain path against the unpadded one and against the JAX kernel) and
its slices of B*H; the widened VAE encoder (last block 576 wide) against JAX's on bridged weights;
the wide float32 kernel's arithmetic repeated in torch (3xTF32, a fresh truncating tensor-core
sum for each 64-column chunk of Q K^T, each block of the pair summing the chunks of its share and
the two partials added once, and for each 8-key chunk of P V), held to the plain version; and
both blocks of a pair emulated at D 520, 768 and 1024, whose softmax statistics and
probabilities agree bit for bit.
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
from diffsim_tpu_torch.ops.kernels.attention import round_bf16
from diffsim_tpu_torch.ops.kernels.attention_stream import (
    MAX_DIM,
    NARROW_MAX_BH,
    bh_slices,
    library_name,
    pad_head_dim,
    streaming_self_attention_plain,
)
from tests.test_torch_port_k1_tf32x3 import LOG2E, mma_sum, passes_of

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


@pytest.mark.parametrize("d", [170, 1020])
def test_padded_heads_match_the_unpadded_plain_version_and_pallas(monkeypatch, d):
    """The wrapper's path for D % 8 != 0 on the card: Q, K and V zero-padded to the next multiple
    of 8 (176, 1024), the softmax scale of the true D, the output's first D columns. In the plain
    version that path equals the unpadded call up to the summation order of the longer logit
    sums, and both the JAX kernel in interpret mode."""
    q, k, v = (_rand((1, 1, 512, d), seed, 0.3) for seed in range(20, 23))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    padded = [pad_head_dim(t) for t in (tq, tk, tv)]
    assert all(t.shape[-1] == d + -d % 8 and t.is_contiguous() for t in padded)
    assert all(torch.equal(p[..., :d], t) and not p[..., d:].any()
               for p, t in zip(padded, (tq, tk, tv)))
    out = streaming_self_attention_plain(*padded, scale=d**-0.5)[..., :d]
    np.testing.assert_allclose(out.numpy(), streaming_self_attention_plain(tq, tk, tv).numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(out.numpy(), _pallas(monkeypatch, q, k, v), atol=ATOL)


@pytest.mark.parametrize("d", [170, 1020])
def test_padded_heads_in_the_bf16_probs_mode_match_pallas(monkeypatch, d):
    """The same path in the fast mode, on a 1/32 grid (exact logits) as
    ``test_k4_bf16_probs_plain_matches_pallas_interpret_past_512`` holds it."""
    q, k = (_grid((1, 1, 512, d), seed) for seed in range(23, 25))
    v = _rand((1, 1, 512, d), 25, 0.3)
    padded = [pad_head_dim(torch.from_numpy(a)) for a in (q, k, v)]
    out = streaming_self_attention_plain(*padded, bf16_probs=True, scale=d**-0.5)[..., :d]
    ref = _pallas(monkeypatch, q, k, v, bf16_probs=True)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=2.0**-7)
    assert np.mean(np.abs(out.numpy() - ref) > 1e-5) <= 0.01


@pytest.mark.parametrize("bh, library, slices", [
    (2, "streaming_attention", [(0, 2)]),
    (NARROW_MAX_BH, "streaming_attention", [(0, NARROW_MAX_BH)]),
    (65536, "streaming_attention", [(0, 65535), (65535, 65536)]),
    (140000, "streaming_attention", [(0, 65535), (65535, 131070), (131070, 140000)]),
    (65536, "streaming_attention_wide", [(0, 65536)]),
])
def test_many_heads_take_a_launch_a_grid_slice(bh, library, slices):
    assert bh_slices(bh, library) == slices


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


def shares(d: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """The columns (c0, w) of D that each block of a pair owns (the kernel's ``Share``): block 0
    the first 64 floor(np / 2) of D's np 64-column panels, block 1 the rest."""
    d0 = 64 * (-(-d // 64) // 2)
    return (0, d0), (d0, d - d0)


def partial_scores(q, kt, share, passes: int = 3):
    """One block's partial score tile: each 64-column chunk of its share (the last cut at the
    share's end) a fresh truncating tensor-core sum of ``passes`` TF32 products, the chunks added
    in order by rounded float32 adds; zeros for an empty share."""
    c0, w = share
    zero = torch.zeros(q.shape[:-1] + (kt.shape[-2],))
    sc = zero
    for c in range(c0, c0 + w, DC):
        cols = slice(c, min(c + DC, c0 + w))
        part = mma_sum(zero, *passes_of(q[..., cols], kt[..., cols].transpose(-1, -2), passes))
        sc = part if c == c0 else sc + part
    return sc


def emulated_wide_f32(q, k, v, passes: int = 3):
    """stream_f32_pair in torch: per 64-key tile, each block's partial over its share
    (:func:`partial_scores`), then S = block 0's + block 1's (one rounded add, the same in either
    order); the online softmax in float32 (the max over the unscaled scores, exp((s - m) scale),
    l = l corr + the tile's sum); the accumulator rescaled by corr, then each 8-key chunk of P V a
    fresh truncating sum added by a rounded add; acc * (1 / l) last. The output columns of a P V
    sum are independent, so one pass over all of D stands for both blocks' shares."""
    s, d = q.shape[-2], q.shape[-1]
    scale = torch.tensor(d**-0.5, dtype=torch.float32)
    m = torch.full(q.shape[:-1] + (1,), -float("inf"))
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    for j in range(0, s, KEYS):
        kt, vt = k[..., j:j + KEYS, :], v[..., j:j + KEYS, :]
        s0, s1 = (partial_scores(q, kt, share, passes) for share in shares(d))
        sc = s0 + s1
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
    """At D = 1024 a score is two partials of 8 chunk sums each, at D = 200 one of 2 chunks and
    one of a chunk and 8 columns; N(0, 1) inputs as chip_smoke.py draws them."""
    q, k, v = (torch.from_numpy(_rand((1, 1, 256, d), 11 + seed)) for seed in range(3))
    err = (emulated_wide_f32(q, k, v) - streaming_self_attention_plain(q, k, v)).abs().max()
    assert err.item() <= CARD_ATOL / 4, err.item()


def test_wide_f32_arithmetic_in_one_tf32_pass_misses_the_card_limit():
    q, k, v = (torch.from_numpy(_rand((1, 1, 256, 1024), 14 + seed)) for seed in range(3))
    err = (emulated_wide_f32(q, k, v, passes=1)
           - streaming_self_attention_plain(q, k, v)).abs().max()
    assert err.item() > CARD_ATOL, err.item()


def test_pair_shares_split_every_width_evenly():
    """Every D % 8 == 0 up to 1024: the two shares tile D, block 1's starts on a 64-column panel,
    both are multiples of 8 and at most 64 columns apart (so neither block waits long on the
    other), and the wider one fits the kernels' 512-column share."""
    for d in range(8, MAX_DIM + 1, 8):
        (c0, w0), (c1, w1) = shares(d)
        assert (c0, c1, c1 + w1) == (0, w0, d) and c1 % 64 == 0
        assert w0 % 8 == 0 and w1 % 8 == 0 and abs(w0 - w1) <= 64 and max(w0, w1) <= 512


def block_softmax(q, k, r: int, bf16_probs: bool):
    """Block r of a pair over every 64-key tile: S = its own partial + its partner's (the
    exchange's add, in block r's order), then the online softmax as stream_f32_pair runs it in
    either mode (the bf16_probs mode: each probability as prob_bf16x2 rounds it, the tile's row
    sum rounded to bf16). Returns each tile's (row max, row sum, probabilities)."""
    d = q.shape[-1]
    scale = torch.tensor(d**-0.5, dtype=torch.float32)
    scale_bf16 = round_bf16(scale).item()
    own, peer = shares(d)[r], shares(d)[1 - r]
    m = torch.full(q.shape[:-1] + (1,), -float("inf"))
    l = torch.zeros_like(m)
    tiles = []
    for j in range(0, k.shape[-2], KEYS):
        kt = k[..., j:j + KEYS, :]
        sc = partial_scores(q, kt, own) + partial_scores(q, kt, peer)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        corr = torch.exp((m - m_new) * scale)
        if bf16_probs:
            p = round_bf16(torch.exp2(round_bf16(round_bf16(sc - m_new) * scale_bf16) * LOG2E))
            tile_sum = round_bf16(p.sum(-1, keepdim=True))
        else:
            p = torch.exp((sc - m_new) * scale)
            tile_sum = p.sum(-1, keepdim=True)
        l = l * corr + tile_sum
        m = m_new
        tiles.append((m, l, p))
    return tiles


@pytest.mark.parametrize("bf16_probs", [False, True])
@pytest.mark.parametrize("d", [520, 768, 1024])
def test_both_blocks_of_a_pair_agree_bit_for_bit(d, bf16_probs):
    """The two blocks of a pair each form S from their own partial and the partner's in their own
    order; addition commutes, so their row maxima, row sums and probabilities agree bit for bit,
    tile by tile, and each applies the same softmax to its own output columns."""
    q, k = (torch.from_numpy(_rand((1, 1, 64, d), 30 + seed)) for seed in range(2))
    k = torch.cat([k, k.flip(-2) * 0.5], dim=-2)  # two tiles, the second rescaling the first
    first, second = (block_softmax(q, k, r, bf16_probs) for r in (0, 1))
    for (m0, l0, p0), (m1, l1, p1) in zip(first, second):
        assert torch.equal(m0, m1) and torch.equal(l0, l1) and torch.equal(p0, p1)
    assert torch.isfinite(first[-1][1]).all() and (first[-1][1] >= 1).all()
