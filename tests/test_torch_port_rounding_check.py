"""The check that ``chip_smoke.py`` holds the CUDA kernels' bf16_probs mode to on the card
(``check_rounding``) must tell the modes apart: an emulation of the kernels' tile loops with
their roundings passes it, and the same loops with the mode ignored, with one rounding left
out, with another sum tile, or the plain versions (which sum unrounded exponentials, as XLA's
CPU compiler does) fail it. Small shapes on the CPU, in float32 and bf16."""

import pytest
import torch

import chip_smoke
from diffsim_tpu_torch.ops.kernels.attention import fused_self_attention_plain, round_bf16
from diffsim_tpu_torch.ops.kernels.attention_stream import streaming_self_attention_plain

SHAPES = {"k1": (1, 2, 512, 40), "k4": (1, 1, 1024, 128)}


def _emulate(q, k, v, fast, tile, sum_tile=None, scale_round=True, p_round=True,
             l_round=True):
    """The kernels' online softmax over ``tile``-key tiles in float32: K1 (``sum_tile`` None)
    rounds the whole row sum to bf16 at the end, K4 each tile's sum as it enters l."""
    b, h, s, d = q.shape
    scale = d**-0.5
    scale_bf16 = round_bf16(torch.tensor(scale)).item() if scale_round else scale
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((b, h, s, 1), -float("inf"))
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, d))
    for j in range(0, s, tile):
        sc = qf @ kf[:, :, j:j + tile].transpose(-1, -2)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        corr = torch.exp((m - m_new) * scale)
        if fast:
            p = torch.exp2(round_bf16(round_bf16(sc - m_new) * scale_bf16) * chip_smoke.LOG2E)
            p = round_bf16(p) if p_round else p
        else:
            p = torch.exp((sc - m_new) * scale)
        ts = p.sum(-1, keepdim=True)
        l = l * corr + (round_bf16(ts) if fast and sum_tile and l_round else ts)
        acc = acc * corr + p.to(v.dtype).float() @ vf[:, :, j:j + tile]
        m = m_new
    if fast and sum_tile is None and l_round:
        l = round_bf16(l)
    return (acc / l).to(v.dtype)


def _kernel(name, variant):
    tile, sum_tile = (64, None) if name == "k1" else (64, 64)

    def run(q, k, v, fast):
        if variant == "faithful":
            return _emulate(q, k, v, fast, tile, sum_tile)
        if variant == "ignores_mode":
            return _emulate(q, k, v, False, tile, sum_tile)
        if variant == "plain":
            plain = fused_self_attention_plain if name == "k1" else streaming_self_attention_plain
            return plain(q, k, v, fast)
        if variant == "other_sum_tile":  # K1 rounding per tile as K4 does; K4 over 128 keys
            return _emulate(q, k, v, fast, 2 * tile if sum_tile else tile,
                            2 * sum_tile if sum_tile else tile)
        return _emulate(q, k, v, fast, tile, sum_tile, **{variant: False})

    return run


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
@pytest.mark.parametrize("name", ["k1", "k4"])
@pytest.mark.parametrize("variant", ["faithful", "ignores_mode", "plain", "scale_round",
                                     "p_round", "l_round", "other_sum_tile"])
def test_rounding_check_tells_the_modes_apart(name, dtype, variant):
    gen = torch.Generator()
    gen.manual_seed(0)
    sum_tile = None if name == "k1" else 64
    check = lambda: chip_smoke.check_rounding(  # noqa: E731
        f"{name} {variant}", _kernel(name, variant), SHAPES[name], dtype, gen, sum_tile)
    if variant == "faithful":
        res = check()
        assert res["disagreement"] <= 0.1 * res["exact_disagreement"]
        assert not res["exact_within_limit"]
    else:
        with pytest.raises(SystemExit, match="does not round as the mode does"):
            check()
