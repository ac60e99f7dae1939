"""k1_roofline: K1 (``fused_self_attention``, ``csrc/fused_attention.cu``) against its
roofline over the traced window: the bound of the self-attentions it took (square, at least
256 tokens in multiples of 256, head dim at most 160), one set a UNet row, over its device
time."""

from portbench.harness.roofline import attention_share


def admits(h, s, d):
    return s >= 256 and s % 256 == 0 and d <= 160


def read(r):
    f32 = r.config["dtype"] == "float32"
    return attention_share(r, r"\battention_(wgmma|tf32)<", "fused_self_attention",
                           r.work.row_sites if r.work else (), lambda d: d.rows, admits,
                           4 if f32 else 2, 3.0 if f32 else 0.0)
