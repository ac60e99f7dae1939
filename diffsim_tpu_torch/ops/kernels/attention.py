"""K1 ``fused_self_attention``: square self-attention over (B, H, S, D).

Replaces the TPU kernel ``diffsim_tpu/ops/pallas/attention.py:fused_self_attention``. The
CUDA kernel is ``csrc/fused_attention.cu`` (design and bound in its header). On a CPU tensor the
wrapper runs :func:`fused_self_attention_plain`, the TPU kernel's arithmetic in torch; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from diffsim_tpu_torch.ops.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_self_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's arithmetic: f32 logits, row max over the unscaled logits, the scale
    folded into exp's operand, probabilities cast to V's dtype before PV (f32 accumulation),
    1/rowsum applied after PV, output in V's dtype."""
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp((logits - m) * scale)
    s = e.sum(dim=-1, keepdim=True)
    pv = torch.matmul(e.to(v.dtype).float(), v.float())
    return (pv * (1.0 / s)).to(v.dtype)


def _lib() -> ctypes.CDLL:
    lib = build.library("fused_attention")
    if lib.fused_attention_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_attention_fwd.argtypes = [p, p, p, p, i, i, i, ctypes.c_float, i, p]
        lib.fused_attention_fwd.restype = i
    return lib


def fused_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) self-attention, softmax scale 1/sqrt(D), output in V's dtype.

    CUDA: contiguous bf16 or float32 tensors of one shape, S % 64 == 0, D % 8 == 0, D <= 160.
    Counts one launch in ``fused_self_attention.launches``."""
    if q.device.type == "cpu":
        return fused_self_attention_plain(q, k, v)
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
                                     b * h, s, d, float(d**-0.5), _DTYPES[q.dtype], stream)
    build.check(lib, rc, "fused_self_attention")
    fused_self_attention.launches += 1
    return out


fused_self_attention.launches = 0
