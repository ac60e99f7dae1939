"""K1 ``fused_self_attention``: square self-attention over (B, H, S, D).

Replaces the TPU kernel ``diffsim_tpu/ops/pallas/attention.py:fused_self_attention``. The
CUDA kernel is ``csrc/fused_attention.cu`` (design and bound in its header). On a CPU tensor the
wrapper runs :func:`fused_self_attention_plain`, the TPU kernel's arithmetic in torch; on a CUDA
tensor it launches the kernel or raises. ``bf16_probs`` is the TPU kernel's fast mode
(``--bf16_softmax``, ``ops/attention.py:fast_softmax``).
"""

from __future__ import annotations

import ctypes

import torch

from diffsim_tpu_torch.ops.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (to nearest even) and back to float32."""
    return x.to(torch.bfloat16).float()


def fast_probs(logits: torch.Tensor, m: torch.Tensor, scale: float) -> torch.Tensor:
    """The unnormalised probabilities of the bf16_probs mode as XLA's CPU compiler computes
    the TPU kernels' fast mode (``centered.astype(bf16)``, then ``exp(centered * scale)``): the
    centred logits rounded to bf16, their product with the scale (a weakly typed constant, so
    itself rounded to bf16) rounded to bf16, and exp in float32. With excess precision allowed
    (XLA's default) the compiler drops the rounding of the exponentials back to bf16."""
    scale_bf16 = round_bf16(torch.tensor(scale)).item()
    return torch.exp(round_bf16(round_bf16(logits - m) * scale_bf16))


def fused_self_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               bf16_probs: bool = False) -> torch.Tensor:
    """The TPU kernel's arithmetic: f32 logits, row max over the unscaled logits, the scale
    folded into exp's operand, probabilities cast to V's dtype before PV (f32 accumulation),
    1/rowsum applied after PV, output in V's dtype.

    ``bf16_probs`` follows the TPU kernel's fast mode as XLA's CPU compiler runs it in
    interpret mode, the reference the tests hold it to: probabilities from :func:`fast_probs`,
    their row sum accumulated in float32 and rounded to bf16 once (``jnp.sum`` of a bf16 tile),
    the probabilities rounded only by the cast to V's dtype. The CUDA kernel rounds each
    probability to bf16 before the sum, as the bf16 tile of the TPU kernel holds them; the two
    agree within bf16 rounding."""
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    m = logits.amax(dim=-1, keepdim=True)
    if bf16_probs:
        e = fast_probs(logits, m, scale)
        s = round_bf16(e.sum(dim=-1, keepdim=True))
    else:
        e = torch.exp((logits - m) * scale)
        s = e.sum(dim=-1, keepdim=True)
    del logits  # the largest buffer: (B, H, S, S) float32
    pv = torch.matmul(e.to(v.dtype).float(), v.float())
    return (pv * (1.0 / s)).to(v.dtype)


def _lib() -> ctypes.CDLL:
    lib = build.library("fused_attention")
    if lib.fused_attention_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_attention_fwd.argtypes = [p, p, p, p, i, i, i, ctypes.c_float, i, i, p]
        lib.fused_attention_fwd.restype = i
    return lib


def fused_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bf16_probs: bool = False) -> torch.Tensor:
    """(B, H, S, D) self-attention, softmax scale 1/sqrt(D), output in V's dtype;
    ``bf16_probs`` selects the fast mode.

    CUDA: contiguous bf16 or float32 tensors of one shape, S % 64 == 0, D % 8 == 0, D <= 160.
    Counts one launch in ``fused_self_attention.launches`` and, in the fast mode, one in
    ``fused_self_attention.launches_bf16_probs``."""
    if q.device.type == "cpu":
        return fused_self_attention_plain(q, k, v, bf16_probs)
    if q.device.type != "cuda":
        raise ValueError(f"fused_self_attention: unsupported device {q.device}")
    if not (q.shape == k.shape == v.shape and q.dim() == 4):
        raise ValueError(f"fused_self_attention: q/k/v must share one (B, H, S, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype and q.dtype in _DTYPES):
        raise ValueError(f"fused_self_attention: dtype {q.dtype}/{k.dtype}/{v.dtype}; "
                         "the kernel takes one of bfloat16, float32")
    if not (q.device == k.device == v.device):
        raise ValueError("fused_self_attention: q/k/v on different devices")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("fused_self_attention: q/k/v must be contiguous and 16-byte aligned")
    b, h, s, d = q.shape
    if s % 64 or d % 8 or d > 160 or b * h > 65535:
        raise ValueError(f"fused_self_attention: shape {tuple(q.shape)} not supported by the "
                         "kernel (S % 64 == 0, D % 8 == 0, D <= 160, B*H <= 65535)")
    out = torch.empty_like(v)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.fused_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                     b * h, s, d, float(d**-0.5), _DTYPES[q.dtype],
                                     int(bf16_probs), stream)
    build.check(lib, rc, "fused_self_attention")
    fused_self_attention.launches += 1
    fused_self_attention.launches_bf16_probs += int(bf16_probs)
    return out


fused_self_attention.launches = 0
fused_self_attention.launches_bf16_probs = 0
