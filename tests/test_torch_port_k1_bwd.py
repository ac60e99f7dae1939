"""K1's backward kernels on the CPU: their algorithms in torch, held to JAX's ``_fused_bwd``.

``csrc/fused_attention_bwd.cu`` computes the gradient rule of the TPU kernel's custom VJP
(``diffsim_tpu/ops/pallas/attention.py:132-151``) in two kernels. A statistics pass, K1's forward
sweep (64-key tiles in float32; in bf16 128 keys a tile up to D 64, else 64, P rounded to bf16
for P V as in the forward), writes each query row's base-2 log-sum-exp L = m scale log2 e +
log2 l and Delta = g . O32, O32 the unrounded P V accumulator over l. A key kernel owns a head's
key blocks (64 keys in float32, 128 in bf16) in order and walks the query tiles: S^T = K Q^T,
dp^T = V g^T, W^T = exp2(S^T scale log2 e - L), dS^T = W^T (dp^T - Delta), dV += W^T g,
dK += dS^T Q, and dQ's share dS K, summed over the key blocks in their order. float32 products
are 3xTF32 mma steps (8 k columns, each step's sum truncated:
``tests/test_torch_port_k1_tf32x3.py``), each a fresh sum a tile; bf16 products are wgmma steps
of 16 k columns on bf16 operands, W^T and dS^T rounded to bf16 once (FlashAttention's
rounding), dV and dK one running sum over the query tiles.

``csrc/fused_attention_bwd_v1.cu`` is the first design, kept as the yardstick that only
``chip_smoke.py`` builds: per block of 64 query rows three sweeps over 64-key tiles (m and l; W,
dp and Delta = rowsum(dp * W); dS and dQ), then per block of 64 keys W^T and dS^T recomputed from
the saved m, l and Delta for dV and dK, the bf16 products with W and dS split into bf16 hi + lo.

Here both emulations are held to JAX's ``_fused_bwd`` at chip_smoke.py's limits (float32 atol
1e-5; bf16 inputs atol = rtol = 1e-2), one bf16 rounding of W and dS is set beside the first
design's split, the wrapper's launch plan and scratch are held to the C entry's contract at every
shape the route admits, and on CPU tensors the backward is the plain version with no build tried.
The kernels themselves run only on the card (``chip_smoke.py``'s phase "K1 under autograd").
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from diffsim_tpu.ops.pallas import attention as pattn
from diffsim_tpu_torch.ops import kernels
from diffsim_tpu_torch.ops.kernels import attention as kattn
from diffsim_tpu_torch.ops.kernels import build, launch
from diffsim_tpu_torch.ops.kernels.attention import round_bf16
from tests.test_torch_port_k1_tf32x3 import LOG2E, mma_sum, passes_of, trunc_f32

TILE = 64  # query rows of an A block, keys of a B block, and the tiles each streams
LIMITS = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-2, 1e-2)}  # chip_smoke.py's (atol, rtol)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small matrix products run faster on one intra-op thread than on many, most of all while
    the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def product(a, b):
    """a @ b in float32 as one fresh sum of 3xTF32 m16n8k8 steps, both operands split, the
    small products first (``mma_sum``)."""
    return mma_sum(torch.zeros(*a.shape[:-1], b.shape[-1]), *passes_of(a, b, 3))


def bf16_product(a_parts, b):
    """sum_i a_i @ b as one fresh sum of bf16 m16n8k16 steps: per step of 16 k columns, one
    product of each a_i with b in order, each added to the running float32 sum exactly and
    truncated (a bf16 product is exact in float32)."""
    c = torch.zeros(*a_parts[0].shape[:-1], b.shape[-1])
    for j in range(0, b.shape[-2], 16):
        for a in a_parts:
            c = trunc_f32(c.double() + a[..., j:j + 16].double() @ b[..., j:j + 16, :].double())
    return c


def split_bf16(x):
    """The bf16 path's split of W or dS: hi rounded to bf16, lo the rest rounded to bf16."""
    hi = round_bf16(x)
    return hi, round_bf16(x - hi)


def emulated_bwd(q, k, v, g, scale=None, one_bf16=False):
    """The first design's (dq, dk, dv) in float32, before the cast to the inputs' dtype, which
    picks the products: float32 3xTF32 with every operand split; bf16 bf16 products of its inputs
    as they are, and of W and dS split into bf16 hi + lo. ``scale`` defaults to 1/sqrt(D).
    ``one_bf16`` rounds W and dS to bf16 once and takes them in one product, FlashAttention's
    way, in place of the split."""
    f32 = q.dtype == torch.float32
    q, k, v, g = (t.float() for t in (q, k, v, g))
    s_len = q.shape[-2]
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    c = torch.tensor(scale * LOG2E, dtype=torch.float32).item()  # scale log2 e, in float32
    tiles = [slice(j, j + TILE) for j in range(0, s_len, TILE)]

    def scores(a, b):  # Q K^T or g V^T of two input tiles
        return product(a, b) if f32 else bf16_product([a], b)

    def weighted(w, b):  # W or dS (float32) times an input tile: the small product first
        if one_bf16:
            return bf16_product([round_bf16(w)], b)
        return product(w, b) if f32 else bf16_product(split_bf16(w)[::-1], b)

    def t(x):
        return x.transpose(-1, -2)

    # A, sweep 1: the running max and sum over the key tiles
    m = torch.full((*q.shape[:-1], 1), -float("inf"))
    l = torch.zeros((*q.shape[:-1], 1))
    for kt in tiles:
        sc = scores(q, t(k[..., kt, :]))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * c)  # 0 on the first tile
        l = l * corr + torch.exp2((sc - m_new) * c).sum(-1, keepdim=True)
        m = m_new
    inv_l = 1.0 / l

    def probs(kt):  # W and dp of the key tile
        w = torch.exp2((scores(q, t(k[..., kt, :])) - m) * c) * inv_l
        return w, scores(g, t(v[..., kt, :]))

    # sweep 2: Delta = rowsum(dp * W); sweep 3: dQ += dS K, a fresh sum a tile
    delta = sum((w * dp).sum(-1, keepdim=True) for w, dp in map(probs, tiles))
    dq = torch.zeros_like(q)
    for kt in tiles:
        w, dp = probs(kt)
        dq = dq + weighted(w * (dp - delta), k[..., kt, :])
    # B: the query tiles with A's m, l and Delta, the keys as rows
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for qt in tiles:
        w_t = torch.exp2((scores(k, t(q[..., qt, :])) - t(m[..., qt, :])) * c)
        w_t = w_t * t(inv_l[..., qt, :])
        dp_t = scores(v, t(g[..., qt, :]))
        dv = dv + weighted(w_t, g[..., qt, :])
        dk = dk + weighted(w_t * (dp_t - t(delta[..., qt, :])), q[..., qt, :])
    return dq * scale, dk * scale, dv


def bf16_running(c, a, b):
    """c + a @ b as a wgmma accumulates it: per step of 16 k columns, the exact bf16 products
    added to the running float32 sum and truncated."""
    for j in range(0, b.shape[-2], 16):
        c = trunc_f32(c.double() + a[..., j:j + 16].double() @ b[..., j:j + 16, :].double())
    return c


def statistics_pass(q, k, v, g, c, f32):
    """The statistics pass's L (base-2 log-sum-exp) and Delta = g . (acc / l) of each row, from
    one online-softmax sweep of K1's forward: exp2 with scale log2 e folded into one FMA against
    the running max, the f32 row sum of the unrounded probabilities; float32 P V a fresh 3xTF32
    sum a 64-key tile added with one FMA, bf16 P rounded to bf16 into the running wgmma sum."""
    dp = -q.shape[-1] % 16 + q.shape[-1]  # the bf16 pipeline's padded width
    bn = 64 if f32 or dp > 64 else 128
    m = torch.full((*q.shape[:-1], 1), -float("inf"))
    l = torch.zeros((*q.shape[:-1], 1))
    acc = torch.zeros_like(q)
    for j in range(0, q.shape[-2], bn):
        kt, vt = k[..., j:j + bn, :], v[..., j:j + bn, :]
        sc = product(q, kt.transpose(-1, -2)) if f32 else bf16_product([q], kt.transpose(-1, -2))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * c)  # 0 on the first tile
        p = torch.exp2((sc.double() * c - (m_new * c).double()).float())  # one FMA
        l = l * corr + p.sum(-1, keepdim=True)
        if f32:
            part = mma_sum(torch.zeros_like(acc), *passes_of(p, vt, 3))
            acc = (acc.double() * corr.double() + part.double()).float()
        else:
            acc = bf16_running(acc * corr, round_bf16(p), vt)
        m = m_new
    return m * c + torch.log2(l), (g * (acc * (1.0 / l))).sum(-1, keepdim=True)


def emulated_bwd_v2(q, k, v, g, scale=None):
    """The shipped design's (dq, dk, dv) in float32, before the cast to the inputs' dtype: the
    statistics pass, then the key blocks in order, each over every query row (the 64-row query
    tiles' sums are fresh a tile in float32, one running sum in bf16), dQ's shares summed in key
    block order. ``scale`` defaults to 1/sqrt(D)."""
    f32 = q.dtype == torch.float32
    q, k, v, g = (t.float() for t in (q, k, v, g))
    s_len = q.shape[-2]
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    c = torch.tensor(scale * LOG2E, dtype=torch.float32).item()  # scale log2 e, in float32
    lse, delta = statistics_pass(q, k, v, g, c, f32)

    def t(x):
        return x.transpose(-1, -2)

    keys = TILE if f32 else 2 * TILE  # a key block's keys
    dq = None
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for j in range(0, s_len, keys):
        kb, at = k[..., j:j + keys, :], slice(j, j + keys)
        if f32:
            s_t, dp_t = product(kb, t(q)), product(v[..., at, :], t(g))
        else:
            s_t, dp_t = bf16_product([kb], t(q)), bf16_product([v[..., at, :]], t(g))
        w_t = torch.exp2((s_t.double() * c - t(lse).double()).float())  # one FMA
        ds_t = w_t * (dp_t - t(delta))
        if f32:
            for i in range(0, s_len, TILE):
                qt = slice(i, i + TILE)
                dv[..., at, :] += product(w_t[..., qt], g[..., qt, :])
                dk[..., at, :] += product(ds_t[..., qt], q[..., qt, :])
            share = product(t(ds_t), kb)
        else:
            w_t, ds_t = round_bf16(w_t), round_bf16(ds_t)
            dv[..., at, :] = bf16_running(dv[..., at, :], w_t, g)
            dk[..., at, :] = bf16_running(dk[..., at, :], ds_t, q)
            share = bf16_product([t(ds_t)], kb)
        dq = share if dq is None else dq + share
    return dq * scale, dk * scale, dv


def _inputs(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
            for _ in range(4)]


def _jax_bwd(q, k, v, g):
    """JAX's ``_fused_bwd`` on the same values, in the inputs' dtype (bf16 through float32)."""
    to_jax = (lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
              if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy()))
    out = pattn._fused_bwd(None, False, tuple(map(to_jax, (q, k, v))), to_jax(g))
    return [torch.from_numpy(np.array(x, dtype=np.float32)) for x in out]


# the DiT training site's heads at its 256 tokens, a narrower head with two samples, and the
# 512 px DiT's 1024 tokens
SHAPES = [(1, 2, 256, 72), (2, 1, 256, 40), (1, 1, 1024, 72)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_the_kernels_algorithm_matches_the_jax_custom_vjp(shape, dtype):
    q, k, v, g = _inputs(shape, sum(shape), dtype)
    ours = [t.to(dtype) for t in emulated_bwd(q, k, v, g)]
    atol, rtol = LIMITS[dtype]
    for name, a, b in zip(("dq", "dk", "dv"), ours, _jax_bwd(q, k, v, g)):
        err = (a.float() - b).abs().max().item()
        print(f"{shape} {dtype} {name}: max |emulated - JAX| = {err:.3e}")
        torch.testing.assert_close(a.float(), b, atol=atol, rtol=rtol)


# the first design's shapes, the 512 px DiT's 1024 tokens at the training site's head, a head off
# the granule (D 36, run zero-padded to 40) and the widest head
V2_SHAPES = SHAPES + [(1, 2, 256, 36), (1, 1, 256, 160)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
@pytest.mark.parametrize("shape", V2_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_the_redesigned_algorithm_matches_the_jax_custom_vjp(shape, dtype):
    """The shipped design, as the wrapper launches it (D zero-padded to 8, the scale at the true
    D), against JAX at the true D; the padded columns of every gradient are zero."""
    q, k, v, g = _inputs(shape, sum(shape), dtype)
    plan = kattn.bwd_launch_plan(shape, dtype)
    padded = [launch.pad_to(t, plan.padded) for t in (q, k, v, g)]
    ours = emulated_bwd_v2(*padded, scale=plan.width**-0.5)
    atol, rtol = LIMITS[dtype]
    for name, a, b in zip(("dq", "dk", "dv"), ours, _jax_bwd(q, k, v, g)):
        assert torch.count_nonzero(a[..., plan.width:]) == 0
        a = a[..., :plan.width].to(dtype).float()
        print(f"{shape} {dtype} {name}: max |emulated - JAX| = {(a - b).abs().max().item():.3e}")
        torch.testing.assert_close(a, b, atol=atol, rtol=rtol)


def test_delta_from_the_forward_output_is_the_rules_rowsum():
    """Delta = g . O32 (the statistics pass's, P rounded to bf16 in bf16) against the rule's
    rowsum(dp * W) in float64 on the same values: the identity holds within the float32 limit in
    float32, and the bf16 pass's rounding of P moves Delta by less than the bf16 limit (the
    gradients' error that follows is held in the test above)."""
    shape = (1, 2, 256, 72)
    for dtype, bound in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        q, k, v, g = (t.float() for t in _inputs(shape, 11, dtype))
        c = torch.tensor(shape[-1] ** -0.5 * LOG2E, dtype=torch.float32).item()
        _, delta = statistics_pass(q, k, v, g, c, dtype == torch.float32)
        qd, kd, vd, gd = (t.double() for t in (q, k, v, g))
        w = torch.softmax(qd @ kd.transpose(-1, -2) * shape[-1] ** -0.5, dim=-1)
        rule = ((gd @ vd.transpose(-1, -2)) * w).sum(-1, keepdim=True)
        err = (delta.double() - rule).abs().max().item()
        print(f"{dtype}: max |Delta - rowsum(dp * W)| = {err:.3e}")
        assert err < bound


def test_padded_heads_give_zero_gradient_columns_and_the_true_widths_gradients():
    """At D 36 the wrapper pads to 40 and passes the scale at 36: the padded columns of every
    gradient are zero, and the first 36 are JAX's at D 36."""
    shape = (1, 2, 256, 36)
    q, k, v, g = _inputs(shape, 36, torch.float32)
    plan = kattn.bwd_launch_plan(shape, torch.float32)
    assert (plan.width, plan.padded) == (36, 40)
    padded = [launch.pad_to(t, plan.padded) for t in (q, k, v, g)]
    ours = emulated_bwd(*padded, scale=plan.width**-0.5)
    for a, b in zip(ours, _jax_bwd(q, k, v, g)):
        assert torch.count_nonzero(a[..., plan.width:]) == 0
        torch.testing.assert_close(a[..., :plan.width], b, atol=1e-5, rtol=0)


def test_the_split_of_w_and_ds_against_one_bf16_rounding():
    """On bf16 inputs, the float32 gradients before the cast, against the rule in float32 on
    the same values: the bf16 hi + lo split of W and dS keeps about 16 bits of them, one bf16
    rounding 8, and the split lands at least ten times closer. Both errors are printed; the
    rounded one need not miss the bf16 limit, whose cast to bf16 is coarser still."""
    shape = (1, 2, 256, 72)
    bf = _inputs(shape, 5, torch.bfloat16)
    ref = _jax_bwd(*(t.float() for t in bf))
    errs = {}
    for one_bf16 in (False, True):
        got = emulated_bwd(*bf, one_bf16=one_bf16)
        errs[one_bf16] = max((a - b).abs().max().item() for a, b in zip(got, ref))
    print(f"max |emulated - rule| before the cast: split {errs[False]:.3e}, "
          f"one bf16 rounding {errs[True]:.3e}")
    assert errs[False] * 10 <= errs[True]


def _bwd_contract(plan, s):
    """``fused_attention_bwd``'s entry check (csrc/fused_attention_bwd.cu, and the first design's
    in csrc/fused_attention_bwd_v1.cu) for each launch."""
    return all(0 < stop - start <= 65535 and s % 64 == 0 and 0 < plan.padded <= 160
               and plan.padded % 8 == 0 for start, stop in plan.slices)


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(b=st.one_of(st.integers(1, 600), st.integers(65000, 200000)), h=st.integers(1, 4),
       s=st.one_of(st.integers(1, 40).map(lambda k: 256 * k), st.integers(1, 10240)),
       d=st.integers(1, 200), dtype=st.sampled_from([torch.float32, torch.bfloat16]))
def test_every_shape_the_route_admits_plans_backward_launches_the_kernel_takes(b, h, s, d, dtype):
    """The backward runs wherever the forward ran: every shape K1's route admits (the JAX
    predicate's shape part) plans launches inside the backward entry's contract, the forward's
    padding and slices on the backward's library."""
    shape = (b, h, s, d)
    with mock.patch.object(pattn, "pallas_route", lambda batch0: True):
        admitted = pattn.use_fused(shape, shape)
    if not admitted:
        return
    plan = kattn.bwd_launch_plan(shape, dtype)
    assert plan.library == "fused_attention_bwd" and plan.library in build.SOURCES
    assert _bwd_contract(plan, s)
    assert plan._replace(library="fused_attention") == kattn.launch_plan(shape, dtype)
    # the scratch holds what every launch's C entry reads and writes: (2 + d) * bh * s floats
    scratch = kattn.bwd_scratch_floats(plan, s)
    assert scratch == max((2 + plan.padded) * (stop - start) * s for start, stop in plan.slices)


def test_cpu_tensors_take_the_plain_backward_and_build_nothing(monkeypatch):
    """On CPU tensors the Function's backward is ``fused_self_attention_bwd_plain``, looked up
    at call time, and no kernel is built or counted."""
    def no_build(*_):
        pytest.fail("a kernel build was tried for CPU tensors")

    monkeypatch.setattr(build, "library", no_build)
    monkeypatch.setattr(build, "build", no_build)
    calls = []
    plain = kattn.fused_self_attention_bwd_plain

    def counting(*args):
        calls.append(1)
        return plain(*args)

    monkeypatch.setattr(kattn, "fused_self_attention_bwd_plain", counting)
    kernels.reset_launch_counts()
    q, k, v, g = _inputs((1, 2, 128, 24), 9, torch.float32)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    grads = torch.autograd.grad(kattn.fused_self_attention(*qkv), qkv, g)
    want = plain(q, k, v, g)
    assert calls == [1]
    for a, b in zip(grads, want):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(kattn.fused_self_attention_bwd(q, k, v, g), want))
    assert kernels.launch_counts()["fused_self_attention_bwd"] == 0
    assert kernels.float32_launch_counts()["fused_self_attention_bwd"] == 0


def test_other_devices_raise():
    q = torch.zeros((1, 1, 64, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kattn.fused_self_attention_bwd(q, q, q, q)
