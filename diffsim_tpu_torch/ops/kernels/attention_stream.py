"""K4 ``streaming_self_attention``: square self-attention for wide heads and long sequences.

Replaces the TPU kernel ``diffsim_tpu/ops/pallas/attention_stream.py:streaming_self_attention``,
both its exact mode and its ``bf16_probs`` fast mode. The CUDA kernel is
``csrc/streaming_attention.cu`` (design and bound in its header). On a CPU tensor the wrapper
runs :func:`streaming_self_attention_plain`; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from diffsim_tpu_torch.ops.kernels import build
from diffsim_tpu_torch.ops.kernels.attention import (
    fast_probs,
    fused_self_attention_plain,
    round_bf16,
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PLAIN_BLOCK_Q = 2048  # query rows per step of the plain version: bounds its logits buffer


def _block_k(s: int) -> int:
    """The TPU kernel's key block (``attention_stream._blocks``): the largest power of two
    <= 256 that divides s, at least 64."""
    bk = 256
    while bk > 64 and s % bk:
        bk //= 2
    return bk


def _online_bf16_probs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The fast mode's online recurrence over the TPU kernel's key blocks, as XLA's CPU
    compiler runs it in interpret mode: per block the running max m' = max(m, rowmax S_j), the
    probabilities of :func:`~diffsim_tpu_torch.ops.kernels.attention.fast_probs` against m', the
    block's row sum accumulated in float32 and rounded to bf16 once, alpha = exp((m - m')
    scale) in float32, l' = l alpha + rowsum, acc' = acc alpha + P V with P cast to V's dtype;
    acc / l at the end."""
    scale = q.shape[-1] ** -0.5
    bk = _block_k(k.shape[-2])
    qf = q.float()
    m = torch.full(q.shape[:-1] + (1,), -torch.inf, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape[:-1] + (v.shape[-1],), device=q.device)
    for j in range(0, k.shape[-2], bk):
        s = torch.matmul(qf, k[..., j:j + bk, :].float().transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = fast_probs(s, m_new, scale)
        alpha = torch.exp((m - m_new) * scale)
        l = l * alpha + round_bf16(p.sum(dim=-1, keepdim=True))
        acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), v[..., j:j + bk, :].float())
        m = m_new
    return (acc / l).to(v.dtype)


def streaming_self_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   bf16_probs: bool = False) -> torch.Tensor:
    """The TPU kernel's arithmetic (f32 logits, row max over the unscaled logits, the scale in
    exp's operand, probabilities cast to V's dtype before PV, f32 accumulation, 1/rowsum last).
    The exact mode takes each row's softmax over all keys at once, which differs from the
    kernel's online recurrence only by rounding; ``bf16_probs`` runs the TPU kernel's online
    recurrence (:func:`_online_bf16_probs`), since its rounding depends on the running max.
    Query rows go in blocks of 2048, so the f32 logits of a 16384-token head take 128 MiB at a
    time instead of 1 GiB."""
    out = torch.empty_like(v)
    for i in range(0, q.shape[-2], _PLAIN_BLOCK_Q):
        rows = slice(i, i + _PLAIN_BLOCK_Q)
        if bf16_probs:
            out[..., rows, :] = _online_bf16_probs(q[..., rows, :], k, v)
        else:
            out[..., rows, :] = fused_self_attention_plain(q[..., rows, :], k, v)
    return out


def _lib() -> ctypes.CDLL:
    lib = build.library("streaming_attention")
    if lib.streaming_attention_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.streaming_attention_fwd.argtypes = [p, p, p, p, i, i, i, ctypes.c_float, i, i, p]
        lib.streaming_attention_fwd.restype = i
    return lib


def streaming_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             bf16_probs: bool = False) -> torch.Tensor:
    """(B, H, S, D) self-attention, softmax scale 1/sqrt(D), output in V's dtype;
    ``bf16_probs`` selects the fast mode.

    CUDA: contiguous tensors of one shape, D <= 512; float32 with S % 64 == 0 and D % 64 == 0,
    bf16 with S % 32 == 0 and D % 8 == 0 (the SDXL VAE's mid attention is (B, 1, 16384, 512)).
    Counts one launch in ``streaming_self_attention.launches`` and, in the fast mode, one in
    ``streaming_self_attention.launches_bf16_probs``."""
    if q.device.type == "cpu":
        return streaming_self_attention_plain(q, k, v, bf16_probs)
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
                                         _DTYPES[q.dtype], int(bf16_probs), stream)
    build.check(lib, rc, "streaming_self_attention")
    streaming_self_attention.launches += 1
    streaming_self_attention.launches_bf16_probs += int(bf16_probs)
    return out


streaming_self_attention.launches = 0
streaming_self_attention.launches_bf16_probs = 0
