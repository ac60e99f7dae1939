"""K4 ``streaming_self_attention``: square self-attention for wide heads and long sequences.

Replaces the TPU kernel ``diffsim_tpu/ops/pallas/attention_stream.py:streaming_self_attention``,
both its exact mode and its ``bf16_probs`` fast mode, at every width its route admits. The CUDA
kernels (design and bound in each header) are two libraries with one entry point,
``streaming_attention_fwd``: ``csrc/streaming_attention.cu`` for D <= 512 (float32 at D % 64 ==
0, as three TF32 products (3xTF32) on ``mma.sync``; bf16 on ``wgmma`` + TMA with a 64-row q block
whose two consumer warpgroups split the keys of Q K^T and the output columns of P V), and
``csrc/streaming_attention_wide.cu`` for the rest (512 < D <= 1024 in both dtypes, and float32
at D % 64 != 0), where a 2-block cluster owns a q block and each block of the pair takes a share
of D for Q K^T and P V, the partial scores exchanged through distributed shared memory. A head
whose D is not a multiple of 8 is zero-padded to the next one (``launch.pad_head_dim``), the
softmax scale kept at the true D, and the output sliced back. On a CPU tensor the wrapper runs
:func:`streaming_self_attention_plain`; on a CUDA tensor it launches a kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from diffsim_tpu_torch.ops.kernels import build, launch
from diffsim_tpu_torch.ops.kernels.attention import (
    fast_probs,
    fused_self_attention_plain,
    round_bf16,
)
from diffsim_tpu_torch.ops.kernels.launch import pad_head_dim  # noqa: F401 (re-exported)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 1024  # the route's widest head (routes.use_streaming)
NARROW_DIM = 512  # the widest head of csrc/streaming_attention.cu
NARROW_MAX_BH = launch.MAX_GRID_ROWS  # csrc/streaming_attention.cu's grid.y: B*H rows a launch
_PLAIN_BLOCK_Q = 2048  # query rows per step of the plain version: bounds its logits buffer


def _block_k(s: int) -> int:
    """The TPU kernel's key block (``attention_stream._blocks``): the largest power of two
    <= 256 that divides s, at least 64."""
    bk = 256
    while bk > 64 and s % bk:
        bk //= 2
    return bk


def _online_bf16_probs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """The fast mode's online recurrence over the TPU kernel's key blocks, as XLA's CPU
    compiler runs it in interpret mode: per block the running max m' = max(m, rowmax S_j), the
    probabilities of :func:`~diffsim_tpu_torch.ops.kernels.attention.fast_probs` against m', the
    block's row sum accumulated in float32 and rounded to bf16 once, alpha = exp((m - m')
    scale) in float32, l' = l alpha + rowsum, acc' = acc alpha + P V with P cast to V's dtype;
    acc / l at the end."""
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
                                   bf16_probs: bool = False,
                                   scale: float | None = None) -> torch.Tensor:
    """The TPU kernel's arithmetic (f32 logits, row max over the unscaled logits, the scale in
    exp's operand, probabilities cast to V's dtype before PV, f32 accumulation, 1/rowsum last).
    The exact mode takes each row's softmax over all keys at once, which differs from the
    kernel's online recurrence only by rounding; ``bf16_probs`` runs the TPU kernel's online
    recurrence (:func:`_online_bf16_probs`), since its rounding depends on the running max.
    Query rows go in blocks of 2048, so the f32 logits of a 16384-token head take 128 MiB at a
    time instead of 1 GiB. ``scale`` defaults to 1/sqrt(D); on heads zero-padded by
    ``launch.pad_head_dim`` it is the unpadded width's, as the kernels take it."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    out = torch.empty_like(v)
    for i in range(0, q.shape[-2], _PLAIN_BLOCK_Q):
        rows = slice(i, i + _PLAIN_BLOCK_Q)
        if bf16_probs:
            out[..., rows, :] = _online_bf16_probs(q[..., rows, :], k, v, scale)
        else:
            out[..., rows, :] = fused_self_attention_plain(q[..., rows, :], k, v, scale=scale)
    return out


def bh_slices(bh: int, library: str) -> list[tuple[int, int]]:
    """The [start, stop) ranges of the B*H rows that one launch of ``library`` takes: all of them
    in ``streaming_attention_wide`` (its grid has no B*H axis limit), slices of at most
    :data:`NARROW_MAX_BH` in ``streaming_attention``."""
    step = max(bh, 1) if library == "streaming_attention_wide" else NARROW_MAX_BH
    return list(launch.row_slices(bh, step))


def library_name(d: int, dtype: torch.dtype) -> str:
    """The library whose kernel takes a head of width ``d``: ``streaming_attention`` up to 512
    (float32 at D % 64 == 0), ``streaming_attention_wide`` past 512 and for float32's other
    widths."""
    if d > NARROW_DIM or (dtype == torch.float32 and d % 64):
        return "streaming_attention_wide"
    return "streaming_attention"


def launch_plan(shape, dtype: torch.dtype) -> launch.LaunchPlan:
    """K4's launches for a (B, H, S, D) call in ``dtype``: D zero-padded to a multiple of 8, the
    library whose kernel takes the padded width (:func:`library_name`) and its B*H slices
    (:func:`bh_slices`). Raises ValueError outside S % 64 == 0, 0 < D <= :data:`MAX_DIM`."""
    b, h, s, d = shape
    if dtype not in _DTYPES or s % 64 or not 0 < d <= MAX_DIM:
        raise ValueError(f"streaming_self_attention: shape {tuple(shape)} {dtype} not supported "
                         f"by the kernel (bfloat16 or float32, S % 64 == 0, D <= {MAX_DIM})")
    dp = launch.padded_width(d, launch.HEAD_GRANULE)
    name = library_name(dp, dtype)
    return launch.LaunchPlan(name, d, dp, tuple(bh_slices(b * h, name)))


def _lib(name: str) -> ctypes.CDLL:
    lib = build.library(name)
    if lib.streaming_attention_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.streaming_attention_fwd.argtypes = [p, p, p, p, i, i, i, ctypes.c_float, i, i, p]
        lib.streaming_attention_fwd.restype = i
    return lib


def streaming_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             bf16_probs: bool = False) -> torch.Tensor:
    """(B, H, S, D) self-attention, softmax scale 1/sqrt(D), output in V's dtype;
    ``bf16_probs`` selects the fast mode.

    CUDA: contiguous tensors of one shape, S % 64 == 0, D <= 1024 (the SDXL VAE's mid attention is
    (B, 1, 16384, 512); a VAE whose last block is 1024 wide gives D = 1024), any B*H. A D that is
    not a multiple of 8 is zero-padded and the output sliced back; B*H past :data:`NARROW_MAX_BH`
    takes one launch a slice in the D <= 512 library (:func:`launch_plan`). Counts each launch in
    ``streaming_self_attention.launches``, in float32 in
    ``streaming_self_attention.launches_float32`` and, in the fast mode, in
    ``streaming_self_attention.launches_bf16_probs``. Not differentiable, as the TPU kernel is not:
    under grad, on inputs that require it, the call raises."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("streaming_self_attention has no backward (the TPU kernel defines no "
                           "VJP either): call it under torch.no_grad() or on detached inputs")
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
    plan = launch_plan(q.shape, q.dtype)
    q, k, v = (launch.pad_to(t, plan.padded) for t in (q, k, v))
    s, dp = q.shape[-2:]
    out = torch.empty_like(v)
    lib = _lib(plan.library)
    row = s * dp * q.element_size()  # bytes of one of the B*H rows
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for start, stop in plan.slices:
            at = start * row
            rc = lib.streaming_attention_fwd(q.data_ptr() + at, k.data_ptr() + at,
                                             v.data_ptr() + at, out.data_ptr() + at,
                                             stop - start, s, dp, float(plan.width**-0.5),
                                             _DTYPES[q.dtype], int(bf16_probs), stream)
            build.check(lib, rc, "streaming_self_attention")
            streaming_self_attention.launches += 1
            streaming_self_attention.launches_float32 += int(q.dtype == torch.float32)
            streaming_self_attention.launches_bf16_probs += int(bf16_probs)
    return out if dp == plan.width else out[..., :plan.width].contiguous()


streaming_self_attention.launches = 0
streaming_self_attention.launches_float32 = 0
streaming_self_attention.launches_bf16_probs = 0
