"""K3's bf16 kernel arithmetic, emulated on the CPU and held to the JAX readout.

``csrc/fused_readout.cu`` streams K/V in key tiles (128 keys at a padded head dim <= 64, else
64) with an online softmax: the running max over the unscaled logits, exp2 with the scale
folded in, the f32 row sum taken before the probabilities are rounded to bf16 unnormalised for
the P V product, and 1 / rowsum applied after the last tile. It reduces each 64-row q tile to one
f32 triple, which the wrapper sums in a fixed order. The TPU kernel normalises before the cast;
the two differ only by rounding. Here that arithmetic is repeated in torch on bf16-rounded inputs
and held to ``pread.cross_self_partials`` and ``pread.fused_direction_score`` (interpret mode)
within chip_smoke.py's K3 bf16 limit: 1e-3 absolute and 1e-3 of the distance (1 - cosine, or the
mse).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from diffsim_tpu.ops.pallas import readout as pread
from diffsim_tpu_torch.ops.kernels import readout as treadout

TOL = 1e-3  # chip_smoke.py's K3 bf16 limit, absolute and relative to the distance


def key_tile(d: int) -> int:
    """The kernel's keys per K/V tile: 128 when the head dim pads to <= 64, else 64."""
    return 128 if (d + 15) // 16 * 16 <= 64 else 64


def online_attention(q, k, v, bn: int) -> torch.Tensor:
    """One pass of the kernel's online softmax over (N, S, D) f32 rows, normalised at the end."""
    scale_log2 = q.shape[-1] ** -0.5 * math.log2(math.e)
    n, s, d = q.shape
    m = torch.full((n, s, 1), -math.inf)
    l = torch.zeros((n, s, 1))
    acc = torch.zeros((n, s, d))
    for j0 in range(0, s, bn):
        logits = q @ k[:, j0:j0 + bn].transpose(-1, -2)  # unscaled
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        corr = torch.exp2((m - m_new) * scale_log2)  # 0 on the first tile
        p = torch.exp2(logits * scale_log2 - m_new * scale_log2)
        l = l * corr + p.sum(dim=-1, keepdim=True)  # the row sum before the cast
        acc = acc * corr + p.to(torch.bfloat16).float() @ v[:, j0:j0 + bn]
        m = m_new
    return acc * (1.0 / l)


def emulated_partials(q, k_cross, v_cross, k_self, v_self, mse: bool = False):
    """The kernel's partials buffer (N, S / 64, 3), then the wrapper's fixed-order sum."""
    bn = key_tile(q.shape[-1])
    o1 = online_attention(q, k_cross, v_cross, bn)
    o2 = online_attention(q, k_self, v_self, bn)
    n, s, d = q.shape
    o1, o2 = (o.reshape(n, s // 64, 64 * d) for o in (o1, o2))
    if mse:
        zeros = torch.zeros((n, s // 64))
        tiles = torch.stack([((o1 - o2) ** 2).sum(-1), zeros, zeros], dim=-1)
    else:
        tiles = torch.stack([(o1 * o2).sum(-1), (o1 * o1).sum(-1), (o2 * o2).sum(-1)], dim=-1)
    sums = tiles.sum(dim=1)
    return sums[:, 0], sums[:, 1], sums[:, 2]


def _taps(shape, seed):
    """bf16-rounded taps as DiffSim's sit (cosine ~0.9): image B's keys and values are image
    A's plus noise."""
    rng = np.random.default_rng(seed)
    qa, ka, va = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    kb, vb = (x + 0.3 * rng.standard_normal(shape).astype(np.float32) for x in (ka, va))
    return [torch.from_numpy(x).to(torch.bfloat16) for x in (qa, ka, va, kb, vb)]


@pytest.mark.parametrize("similarity", ["cosine", "mse"])
@pytest.mark.parametrize("shape", [(1, 2, 2, 512, 64), (1, 1, 2, 512, 40), (1, 1, 2, 512, 72)])
def test_online_readout_matches_the_pallas_readout(shape, similarity):
    taps = _taps(shape, seed=sum(shape))
    jax_taps = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in taps]
    p, b, h, s, d = shape
    rows = [t.float().reshape(p * b * h, s, d) for t in (taps[0], taps[3], taps[4], taps[1],
                                                          taps[2])]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pread.fused_direction_score(*jax_taps, similarity))
        if similarity == "cosine":  # the three partials (the mse score is its one partial)
            ref_parts = pread.cross_self_partials(*(jnp.asarray(r.numpy()).astype(jnp.bfloat16)
                                                    for r in rows))
            for ours, theirs in zip(emulated_partials(*rows), ref_parts):
                np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=TOL, atol=1e-6)
    out = treadout._direction_score(emulated_partials, *(t.float() for t in taps),
                                    similarity).numpy()
    dist = np.abs(1.0 - ref if similarity == "cosine" else ref)
    err = np.abs(out - ref)
    assert (err <= TOL).all() and (err <= TOL * dist).all(), (out, ref)
