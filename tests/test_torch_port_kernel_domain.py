"""K1, K2 and K3 at every shape their routes admit, on the CPU.

The routes (``ops/kernels/routes.py``, the JAX predicates' shape parts) admit heads of any D up to
160 (K1) or 128 (K3), feed-forwards of any C up to 640 (K2) and any number of rows, while the C
entries take D % 8 == 0, C % 32 == 0 and at most 65535 rows (K2: 65535 tiles of 64 rows) a
launch. Each wrapper brings an admitted shape inside its entry's contract by its launch plan
(``launch_plan``): the last dimension zero-padded to the granule (for K2 the weights too, W1's h
and gate halves apart), the softmax scale kept at the true D, and one launch a slice of rows.
The kernels themselves run only on the card (``chip_smoke.py``'s phase "K1-K3 at the shapes
their kernels take only through the wrapper" holds them there). Here: the plain versions against
the JAX package's Pallas kernels in interpret mode at off-granule shapes; the padded-then-sliced
plain calls against the unpadded ones; every launch of every plan of a route-admitted shape
against its C entry's contract; and K1's gradient at D 36 through ``FusedSelfAttention``
against the JAX custom VJP, with the forward padded as on the card.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental.pallas import tpu as pltpu

from diffsim_tpu.ops.pallas import attention as pattn
from diffsim_tpu.ops.pallas import ff as pff
from diffsim_tpu.ops.pallas import readout as pread
from diffsim_tpu_torch.ops.kernels import attention as kattn
from diffsim_tpu_torch.ops.kernels import ff as kff
from diffsim_tpu_torch.ops.kernels import launch
from diffsim_tpu_torch.ops.kernels import readout as kread

ATOL = 2e-5  # plain versions against the Pallas kernels in interpret mode, exact modes
# the bf16_probs mode on exact logits: a row sum rounded to bf16 may flip with the float32 order
# of its terms, scaling that row by 1 +- 2^-8 (tests/test_torch_port_fast.py's limits)
FAST_RTOL = 2.0**-7
FLIP_SHARE = 0.01
PAD_TOL = 1e-6  # padded against unpadded plain calls, atol = rtol: float32 summation order
DTYPES = (torch.float32, torch.bfloat16)


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


def _grid(shape, seed, step=1 / 8):
    """Multiples of ``step`` in [-16 step, 16 step]: products and sums of a logit are exact."""
    return (np.random.default_rng(seed).integers(-16, 17, shape) * step).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _ff_weights(c, seed):
    """x-free GEGLU weights in the JAX layout: W1 (C, 8C), b1, W2 (4C, C), b2."""
    return (_rand((c, 8 * c), seed, c**-0.5), _rand((8 * c,), seed + 1, 0.1),
            _rand((4 * c, c), seed + 2, (4 * c) ** -0.5), _rand((c,), seed + 3, 0.1))


def _linear_layout(w1, b1, w2, b2):
    """The JAX layout's weights in the port's nn.Linear (out, in) layout."""
    return _t(w1.T.copy(), b1, w2.T.copy(), b2)


# ---------------------------------------------------------------------------
# (a) the plain versions against JAX interpret mode at off-granule shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [20, 36])
def test_k1_plain_matches_pallas_interpret_off_the_granule(d):
    q, k, v = (_rand((1, 2, 256, d), seed) for seed in range(3))
    with pltpu.force_tpu_interpret_mode():
        ref = pattn.fused_self_attention(*(jnp.asarray(a) for a in (q, k, v)))
    out = kattn.fused_self_attention_plain(*_t(q, k, v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("d", [20, 36])
def test_k1_bf16_probs_plain_matches_pallas_interpret_off_the_granule(d):
    q, k = (_grid((1, 2, 256, d), seed) for seed in range(3, 5))
    v = _rand((1, 2, 256, d), 5)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pattn.fused_self_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                                    bf16_probs=True))
        exact = np.asarray(pattn.fused_self_attention(*(jnp.asarray(a) for a in (q, k, v))))
    out = kattn.fused_self_attention_plain(*_t(q, k, v), bf16_probs=True).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=FAST_RTOL)
    assert np.mean(np.abs(out - ref) > 1e-5) <= FLIP_SHARE
    assert np.abs(ref - exact).max() > 1e-4  # a distinct mode


@pytest.mark.parametrize("c", [40, 72])
def test_k2_plain_matches_pallas_interpret_off_the_granule(c):
    n = 512
    x = _rand((n, c), 6)
    w = _ff_weights(c, 7)
    with pltpu.force_tpu_interpret_mode():
        ref = pff.fused_geglu_ff(*(jnp.asarray(a) for a in (x, *w)),
                                 block_rows=pff._block_rows(n, c))
    out = kff.fused_geglu_ff_plain(torch.from_numpy(x), *_linear_layout(*w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("similarity", ["cosine", "mse"])
def test_k3_plain_matches_pallas_interpret_off_the_granule(similarity):
    qa, ka, va = (_rand((2, 2, 2, 512, 20), seed) for seed in range(11, 14))
    kb, vb = (x + 0.3 * _rand(x.shape, seed) for x, seed in ((ka, 14), (va, 15)))
    with pltpu.force_tpu_interpret_mode():
        ref = pread.fused_direction_score(*(jnp.asarray(a) for a in (qa, ka, va, kb, vb)),
                                          similarity)
    out = kread.fused_direction_score_plain(*_t(qa, ka, va, kb, vb), similarity)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


# ---------------------------------------------------------------------------
# (b) the wrappers' padding arithmetic on the plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bf16_probs", [False, True])
@pytest.mark.parametrize("d", [20, 36, 100, 156])
def test_k1_padded_heads_match_the_unpadded_plain_version(d, bf16_probs):
    """The wrapper's padded call (Q, K, V zero-padded to the plan's width, the scale at the true
    D, the output sliced back) on the plain version, against the unpadded plain call; exact
    logits on a 1/8 grid, so the bf16_probs mode's roundings see the same values."""
    q, k = (_grid((2, 3, 64, d), seed) for seed in range(20, 22))
    v = _rand((2, 3, 64, d), 22)
    plan = kattn.launch_plan(q.shape, torch.float32)
    assert plan.padded == d + -d % 8 and plan.width == d
    padded = [launch.pad_to(t, plan.padded) for t in _t(q, k, v)]
    out = kattn.fused_self_attention_plain(*padded, bf16_probs, scale=d**-0.5)[..., :d]
    ref = kattn.fused_self_attention_plain(*_t(q, k, v), bf16_probs)
    torch.testing.assert_close(out, ref, atol=PAD_TOL, rtol=PAD_TOL)
    # the scale of the padded width is a different function, which the check above tells apart
    wrong = kattn.fused_self_attention_plain(*padded, bf16_probs)[..., :d]
    assert (wrong - ref).abs().max() > 1e-3


@pytest.mark.parametrize("mse", [False, True])
@pytest.mark.parametrize("d", [20, 100])
def test_k3_padded_heads_match_the_unpadded_plain_version(d, mse):
    rows = _t(*(_rand((4, 128, d), seed, 0.5) for seed in range(30, 35)))
    plan = kread.launch_plan(rows[0].shape, torch.float32)
    padded = [launch.pad_to(t, plan.padded) for t in rows]
    for ours, ref in zip(kread.cross_self_partials_plain(*padded, mse=mse, scale=d**-0.5),
                         kread.cross_self_partials_plain(*rows, mse=mse)):
        torch.testing.assert_close(ours, ref, atol=0, rtol=PAD_TOL)


def _padded_partials(*rows, mse=False):
    """``cross_self_partials``'s CUDA path with the plain version standing in for the kernel."""
    plan = kread.launch_plan(rows[0].shape, rows[0].dtype)
    padded = [launch.pad_to(t, plan.padded) for t in rows]
    return kread.cross_self_partials_plain(*padded, mse=mse, scale=plan.width**-0.5)


@pytest.mark.parametrize("similarity", ["cosine", "mse"])
def test_k3_padded_scores_keep_the_callers_width(similarity):
    """The scores through padded partials equal the unpadded ones: mse divides by the caller's
    D, since the padding happens below ``_direction_score``."""
    taps = _t(*(_rand((2, 2, 2, 128, 20), seed) for seed in range(40, 45)))
    out = kread._direction_score(_padded_partials, *taps, similarity)
    ref = kread.fused_direction_score_plain(*taps, similarity)
    torch.testing.assert_close(out, ref, atol=1e-7, rtol=PAD_TOL)


def _naive_w1(w1, cp):
    """W1 zero-padded as one block: its gate rows left at [4C, 8C) instead of [4cp, 4cp + 4C)."""
    c = w1.shape[1]
    out = w1.new_zeros((8 * cp, cp))
    out[:8 * c, :c] = w1
    return out


@pytest.mark.parametrize("c", [8, 40, 72, 200, 600])
def test_k2_padded_weights_match_the_unpadded_plain_version(c):
    """x, W1 (h and gate halves apart), b1, W2 and b2 zero-padded to the plan's width, the
    output sliced back, on the plain version: the unpadded output to float32 summation order.
    W1 padded as one block instead puts gate rows where h rows belong and gives another
    function, O(1) away."""
    x = torch.from_numpy(_rand((64, c), 50))
    w1, b1, w2, b2 = _linear_layout(*_ff_weights(c, 51))
    plan = kff.launch_plan(x.shape, torch.float32)
    cp = plan.padded
    assert cp % 32 == 0 and cp - c < 32 and cp > c
    pw = kff.pad_weights(w1, b1, w2, b2, cp)
    assert [tuple(t.shape) for t in pw] == [(8 * cp, cp), (8 * cp,), (cp, 4 * cp), (cp,)]
    xp = launch.pad_to(x, cp)
    out = kff.fused_geglu_ff_plain(xp, *pw)
    assert out[:, c:].abs().max() == 0  # padded output columns are zero
    ref = kff.fused_geglu_ff_plain(x, w1, b1, w2, b2)
    torch.testing.assert_close(out[:, :c], ref, atol=PAD_TOL, rtol=PAD_TOL)
    misplaced = kff.fused_geglu_ff_plain(xp, _naive_w1(w1, cp), *pw[1:])[:, :c]
    assert (misplaced - ref).abs().max() > 0.1


def test_k2_weights_on_the_granule_are_passed_as_they_are():
    w = _linear_layout(*_ff_weights(32, 60))
    assert all(a is b for a, b in zip(kff.pad_weights(*w, 32), w))


# ---------------------------------------------------------------------------
# (c) the launch plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows, slices", [
    (1, ((0, 1),)),
    (65535, ((0, 65535),)),
    (65536, ((0, 65535), (65535, 65536))),
    (140000, ((0, 65535), (65535, 131070), (131070, 140000))),
    (0, ()),
])
def test_k1_and_k3_take_a_launch_a_grid_slice(rows, slices):
    assert kattn.launch_plan((rows, 1, 64, 40), torch.float32).slices == slices
    assert kattn.launch_plan((1, rows, 64, 40), torch.bfloat16).slices == slices
    assert kread.launch_plan((rows, 64, 40), torch.float32).slices == slices


@pytest.mark.parametrize("tiles, slices", [
    (65535, ((0, 65535 * 64),)),
    (65536, ((0, 65535 * 64), (65535 * 64, 65536 * 64))),
    (140000, ((0, 65535 * 64), (65535 * 64, 131070 * 64), (131070 * 64, 140000 * 64))),
])
def test_k2_takes_a_launch_a_grid_slice_of_64_row_tiles(tiles, slices):
    assert kff.launch_plan((tiles * 64, 32), torch.float32).slices == slices
    # the split shape chip_smoke.py drives: one 64-row tile past the grid
    assert kff.launch_plan((65535 * 64 + 64, 32), torch.bfloat16).slices[-1] == (
        65535 * 64, 65535 * 64 + 64)


def _k1_contract(plan, s):
    """``fused_attention_fwd``'s entry check (csrc/fused_attention.cu) for each launch."""
    return all(0 < stop - start <= 65535 and s % 64 == 0 and 0 < plan.padded <= 160
               and plan.padded % 8 == 0 for start, stop in plan.slices)


def _k3_contract(plan, s):
    """``fused_readout_fwd``'s entry check (csrc/fused_readout.cu, fused_readout_f32.cu)."""
    return all(0 < stop - start <= 65535 and s % 64 == 0 and 0 < plan.padded <= 128
               and plan.padded % 8 == 0 for start, stop in plan.slices)


def _k2_contract(plan):
    """``geglu_ff_fwd``'s entry check (csrc/geglu_ff.cu), ``ff.kernel_takes``."""
    return all(kff.kernel_takes(stop - start, plan.padded) for start, stop in plan.slices)


def _covers(plan, rows, width, granule):
    """The slices tile [0, rows) in order, and the padded width is the true one rounded up to
    the granule."""
    bounds = [b for sl in plan.slices for b in sl]
    return (bounds[:1] in ([], [0]) and bounds[-1:] in ([], [rows])
            and all(a == b for a, b in zip(bounds[1:-1:2], bounds[2::2]))
            and plan.width == width <= plan.padded < width + granule
            and plan.padded % granule == 0)


def _jax_routes_everywhere():
    """The JAX predicates with their platform gate open, leaving only their shape parts."""
    return mock.patch.object(pattn, "pallas_route", lambda batch0: True)


PLAN_SETTINGS = settings(max_examples=300, deadline=None, derandomize=True, database=None)
SEQ = st.one_of(st.integers(1, 40).map(lambda k: 256 * k), st.integers(1, 10240))
ROWS = st.one_of(st.integers(1, 600), st.integers(65000, 200000))


@PLAN_SETTINGS
@given(b=ROWS, h=st.integers(1, 4), s=SEQ, d=st.integers(1, 200),
       dtype=st.sampled_from(DTYPES))
def test_every_k1_shape_the_route_admits_plans_launches_the_kernel_takes(b, h, s, d, dtype):
    shape = (b, h, s, d)
    with _jax_routes_everywhere():
        admitted = pattn.use_fused(shape, shape)
    if not admitted:
        return
    plan = kattn.launch_plan(shape, dtype)
    assert _k1_contract(plan, s) and _covers(plan, b * h, d, 8)


@PLAN_SETTINGS
@given(p=st.integers(1, 4), bh=ROWS, s=st.one_of(st.integers(1, 8).map(lambda k: 512 * k),
                                                 st.integers(1, 8192)),
       d=st.integers(1, 160), dtype=st.sampled_from(DTYPES))
def test_every_k3_shape_the_route_admits_plans_launches_the_kernel_takes(p, bh, s, d, dtype):
    shape = (p, 1, bh, s, d)
    with _jax_routes_everywhere():
        admitted = pread.use_fused_readout(shape)
    if not admitted:
        return
    plan = kread.launch_plan((p * bh, s, d), dtype)
    assert _k3_contract(plan, s) and _covers(plan, p * bh, d, 8)
    assert plan.library == {torch.float32: "fused_readout_f32",
                            torch.bfloat16: "fused_readout"}[dtype]


@PLAN_SETTINGS
@given(n=st.one_of(st.integers(0, 20000), st.integers(4194000, 9000000)), c=st.integers(1, 700),
       dtype=st.sampled_from(DTYPES))
def test_every_k2_shape_the_route_admits_plans_launches_the_kernel_takes(n, c, dtype):
    with _jax_routes_everywhere():
        admitted = pff.use_fused_ff(n, c, 8 * c)
    if not admitted:
        return
    plan = kff.launch_plan((n, c), dtype)
    assert plan.padded <= 640 and _k2_contract(plan) and _covers(plan, n, c, 32)


@pytest.mark.parametrize("plan_of, shape", [
    (kattn.launch_plan, (1, 1, 256, 161)),
    (kattn.launch_plan, (1, 1, 100, 64)),
    (kread.launch_plan, (1, 512, 129)),
    (kread.launch_plan, (1, 100, 64)),
    (kff.launch_plan, (64, 641)),
    (kff.launch_plan, (64, 0)),
])
def test_shapes_outside_the_routes_still_raise(plan_of, shape):
    with pytest.raises(ValueError, match="not supported by the kernel"):
        plan_of(shape, torch.float32)


def test_plans_refuse_other_dtypes():
    with pytest.raises(ValueError, match="not supported by the kernel"):
        kattn.launch_plan((1, 1, 256, 40), torch.float16)


def test_k2_past_the_routes_width_keeps_the_kernels_own_widths():
    """C > 640 is outside the route; the kernels take it at C % 32 == 0 (chip_smoke.py drives
    (6144, 1280) directly), unpadded, as before."""
    plan = kff.launch_plan((24 * 256, 1280), torch.bfloat16)
    assert plan.padded == 1280 and _k2_contract(plan)


# ---------------------------------------------------------------------------
# (d) K1's gradient at D 36
# ---------------------------------------------------------------------------


def _padded_dispatch(q, k, v, bf16_probs):
    """K1's CUDA path with the plain version standing in for the kernel: the plan's padding, the
    scale at the true D, the output sliced back."""
    plan = kattn.launch_plan(q.shape, q.dtype)
    padded = [launch.pad_to(t, plan.padded) for t in (q, k, v)]
    out = kattn.fused_self_attention_plain(*padded, bf16_probs, scale=plan.width**-0.5)
    return out[..., :plan.width].contiguous()


@pytest.mark.parametrize("padded_forward", [False, True])
def test_k1_gradient_at_d36_matches_the_jax_custom_vjp(monkeypatch, padded_forward):
    """Through the Function, the port of ``_fused_bwd`` within 1e-5 of JAX's. With the forward
    padded as on the card, the Function still saves the caller's unpadded q, k and v, so the
    backward runs at the true D and its scale."""
    shape = (1, 2, 256, 36)
    q, k, v, g = (_rand(shape, seed) for seed in range(70, 74))
    ref = pattn._fused_bwd(None, False, tuple(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(g))
    if padded_forward:
        monkeypatch.setattr(kattn, "_dispatch", _padded_dispatch)
    qkv = [t.requires_grad_() for t in _t(q, k, v)]
    out = kattn.fused_self_attention(*qkv)
    assert type(out.grad_fn).__name__ == "FusedSelfAttentionBackward"
    assert [tuple(t.shape) for t in out.grad_fn.saved_tensors] == [shape] * 3
    with torch.no_grad():
        torch.testing.assert_close(out, kattn.fused_self_attention_plain(*qkv), atol=PAD_TOL,
                                   rtol=PAD_TOL)
    grads = torch.autograd.grad(out, qkv, torch.from_numpy(g))
    for ours, theirs in zip(grads, ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=1e-5)
