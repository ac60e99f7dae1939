"""K4 ``streaming_self_attention``: square self-attention for wide heads and long sequences.

Replaces the TPU kernel ``diffsim_tpu/ops/pallas/attention_stream.py:streaming_self_attention``
(its exact mode; ``bf16_probs`` is not ported). The CUDA kernel is
``csrc/streaming_attention.cu`` (design and bound in its header). On a CPU tensor the wrapper
runs :func:`streaming_self_attention_plain`; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from diffsim_tpu_torch.ops.kernels import build
from diffsim_tpu_torch.ops.kernels.attention import fused_self_attention_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PLAIN_BLOCK_Q = 2048  # query rows per step of the plain version: bounds its logits buffer


def streaming_self_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's arithmetic (f32 logits, row max over the unscaled logits, the scale in
    exp's operand, probabilities cast to V's dtype before PV, f32 accumulation, 1/rowsum last),
    with each row's softmax taken over all keys at once. That differs from the kernel's online
    recurrence only by rounding. Query rows go in blocks of 2048, so the f32 logits of a
    16384-token head take 128 MiB at a time instead of 1 GiB."""
    out = torch.empty_like(v)
    for i in range(0, q.shape[-2], _PLAIN_BLOCK_Q):
        rows = slice(i, i + _PLAIN_BLOCK_Q)
        out[..., rows, :] = fused_self_attention_plain(q[..., rows, :], k, v)
    return out


def _lib() -> ctypes.CDLL:
    lib = build.library("streaming_attention")
    if lib.streaming_attention_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.streaming_attention_fwd.argtypes = [p, p, p, p, i, i, i, ctypes.c_float, i, p]
        lib.streaming_attention_fwd.restype = i
    return lib


def streaming_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) self-attention, softmax scale 1/sqrt(D), output in V's dtype.

    CUDA: contiguous tensors of one shape, D <= 512; float32 with S % 64 == 0 and D % 64 == 0,
    bf16 with S % 32 == 0 and D % 8 == 0 (the SDXL VAE's mid attention is (B, 1, 16384, 512)).
    Counts one launch in ``streaming_self_attention.launches``."""
    if q.device.type == "cpu":
        return streaming_self_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"streaming_self_attention: unsupported device {q.device}")
    if not (q.shape == k.shape == v.shape and q.dim() == 4):
        raise ValueError(f"streaming_self_attention: q/k/v must share one (B, H, S, D) shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype and q.dtype in _DTYPES):
        raise ValueError(f"streaming_self_attention: dtype {q.dtype}/{k.dtype}/{v.dtype}; "
                         "the kernel takes one of bfloat16, float32")
    if not (q.device == k.device == v.device):
        raise ValueError("streaming_self_attention: q/k/v on different devices")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("streaming_self_attention: q/k/v must be contiguous and 16-byte "
                             "aligned")
    b, h, s, d = q.shape
    s_step, d_step = (64, 64) if q.dtype == torch.float32 else (32, 8)
    if s % s_step or d % d_step or d > 512 or b * h > 65535:
        raise ValueError(f"streaming_self_attention: shape {tuple(q.shape)} {q.dtype} not "
                         f"supported by the kernel (S % {s_step} == 0, D % {d_step} == 0, "
                         "D <= 512, B*H <= 65535)")
    out = torch.empty_like(v)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.streaming_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                         out.data_ptr(), b * h, s, d, float(d**-0.5),
                                         _DTYPES[q.dtype], stream)
    build.check(lib, rc, "streaming_self_attention")
    streaming_self_attention.launches += 1
    return out


streaming_self_attention.launches = 0
