"""K1 ``fused_self_attention``: square self-attention over (B, H, S, D).

Replaces the TPU kernel ``diffsim_tpu/ops/pallas/attention.py:fused_self_attention``. The
CUDA kernel is ``csrc/fused_attention.cu`` (design and bound in its header): bf16 on ``wgmma`` +
TMA, float32 as three TF32 products (3xTF32) on ``mma.sync`` with the scores and probabilities
in registers. On a CPU tensor the wrapper runs :func:`fused_self_attention_plain`, the TPU
kernel's arithmetic in torch; on a CUDA tensor it launches the kernel or raises. Every shape the
route admits is launched (:func:`launch_plan`): a D off the kernel's granule of 8 zero-padded,
the scale kept at the true D, and B*H past the grid's 65535 in slices. ``bf16_probs`` is the TPU
kernel's fast mode (``--bf16_softmax``, ``ops/attention.py:fast_softmax``).

Under grad (grad mode on and an input that requires it) the call goes through
:class:`FusedSelfAttention`, the counterpart of the TPU kernel's custom VJP: the forward is the
same dispatch, the backward :func:`fused_self_attention_bwd`, the gradient rule ``_fused_bwd``
(``diffsim_tpu/ops/pallas/attention.py:132-151``). On a CUDA tensor that is the kernels of
``csrc/fused_attention_bwd.cu`` (design and bound in its header: a statistics pass, then a
key-parallel kernel); on a CPU tensor its plain version :func:`fused_self_attention_bwd_plain`,
the rule line for line in ``torch.matmul``.
"""

from __future__ import annotations

import ctypes

import torch

from diffsim_tpu_torch.ops.kernels import build, launch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 160  # the route's widest head (routes.use_fused) and the kernel's


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
                               bf16_probs: bool = False,
                               scale: float | None = None) -> torch.Tensor:
    """The TPU kernel's arithmetic: f32 logits, row max over the unscaled logits, the scale
    folded into exp's operand, probabilities cast to V's dtype before PV (f32 accumulation),
    1/rowsum applied after PV, output in V's dtype.

    ``bf16_probs`` follows the TPU kernel's fast mode as XLA's CPU compiler runs it in
    interpret mode, the reference the tests hold it to: probabilities from :func:`fast_probs`,
    their row sum accumulated in float32 and rounded to bf16 once (``jnp.sum`` of a bf16 tile),
    the probabilities rounded only by the cast to V's dtype. The CUDA kernel rounds each
    probability to bf16 before the sum, as the bf16 tile of the TPU kernel holds them; the two
    agree within bf16 rounding. ``scale`` defaults to 1/sqrt(D); a caller that zero-pads the
    head passes the unpadded width's."""
    if scale is None:
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


def fused_self_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   g: torch.Tensor):
    """The TPU kernel's backward (``_fused_bwd``), line for line: the f32 logits and softmax
    recomputed, ``dv = W^T g``, ``dp = g V^T``, ``tmp = (dp - rowsum(dp * W)) * W``,
    ``dq = tmp K * scale``, ``dk = tmp^T Q * scale``, each gradient cast to its input's dtype.
    Exact whatever mode the forward took (the bf16_probs mode is forward-only, as in JAX). The
    (B, H, S, S) float32 weights are materialised, as XLA's backward does."""
    scale = q.shape[-1] ** -0.5
    qf, kf = q.float(), k.float()
    w = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
    g32 = g.float()
    dv = torch.matmul(w.transpose(-1, -2), g32)
    tmp = torch.matmul(g32, v.float().transpose(-1, -2))  # dp, made tmp in place
    tmp -= (tmp * w).sum(dim=-1, keepdim=True)
    tmp *= w
    del w
    dq = torch.matmul(tmp, kf) * scale
    dk = torch.matmul(tmp.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _lib(name: str) -> ctypes.CDLL:
    lib = build.library(name)
    if lib.fused_attention_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_attention_fwd.argtypes = [p, p, p, p, i, i, i, ctypes.c_float, i, i, p]
        lib.fused_attention_fwd.restype = i
    return lib


def _bwd_lib(name: str) -> ctypes.CDLL:
    lib = build.library(name)
    if lib.fused_attention_bwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_attention_bwd.argtypes = [p] * 8 + [i, i, i, ctypes.c_float, i, p]
        lib.fused_attention_bwd.restype = i
    return lib


def launch_plan(shape, dtype: torch.dtype) -> launch.LaunchPlan:
    """K1's launches for a (B, H, S, D) call in ``dtype``: D zero-padded to a multiple of 8 (at
    most 160), one launch a slice of at most 65535 B*H rows. Raises ValueError outside
    S % 64 == 0, 0 < D <= 160, or off bfloat16 and float32."""
    b, h, s, d = shape
    if dtype not in _DTYPES or s % 64 or not 0 < d <= MAX_DIM:
        raise ValueError(f"fused_self_attention: shape {tuple(shape)} {dtype} not supported by "
                         f"the kernel (bfloat16 or float32, S % 64 == 0, D <= {MAX_DIM})")
    return launch.LaunchPlan("fused_attention", d, launch.padded_width(d, launch.HEAD_GRANULE),
                             launch.row_slices(b * h))


def bwd_launch_plan(shape, dtype: torch.dtype) -> launch.LaunchPlan:
    """The backward's launches for a (B, H, S, D) call: the forward's plan (:func:`launch_plan`,
    the same shapes admitted, D zero-padded to 8, slices of 65535 B*H rows) on the backward's
    library."""
    return launch_plan(shape, dtype)._replace(library="fused_attention_bwd")


def bwd_scratch_floats(plan: launch.LaunchPlan, s: int) -> int:
    """The float32 scratch that each launch of ``plan`` at S = ``s`` hands the backward's C
    entry, reused slice after slice: (2 + padded D) values a row of the largest slice, its
    row's log-sum-exp and Delta (the statistics pass's) and its row of dQ's float32 accumulator
    over the key blocks."""
    rows = max((stop - start for start, stop in plan.slices), default=0)
    return (2 + plan.padded) * rows * s


class FusedSelfAttention(torch.autograd.Function):
    """K1 under autograd: the forward dispatches as :func:`fused_self_attention` does without
    grad (counting its launches), saves q, k and v as the caller gave them (unpadded, so the
    backward runs at the true D and scale); the backward is :func:`fused_self_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, bf16_probs):
        ctx.save_for_backward(q, k, v)
        return _dispatch(q, k, v, bf16_probs)

    @staticmethod
    def backward(ctx, g):
        return (*fused_self_attention_bwd(*ctx.saved_tensors, g.contiguous()), None)


def fused_self_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             g: torch.Tensor):
    """(dq, dk, dv) of :func:`fused_self_attention` at (q, k, v) for the output's gradient g,
    the rule ``_fused_bwd``, each in its input's dtype.

    CPU: :func:`fused_self_attention_bwd_plain`. CUDA: contiguous, 16-byte aligned bf16 or
    float32 tensors of one (B, H, S, D) shape, at every shape the forward admits
    (:func:`bwd_launch_plan`): D zero-padded to a multiple of 8 (the padded columns of the
    gradients are zero and are dropped), the scale at the true D, one launch a slice of 65535
    B*H rows. Each launch runs the statistics pass and the key kernel on a float32 scratch of
    :func:`bwd_scratch_floats` and counts in ``fused_self_attention_bwd.launches`` and, in
    float32, ``fused_self_attention_bwd.launches_float32``."""
    if q.device.type == "cpu":
        return fused_self_attention_bwd_plain(q, k, v, g)
    if q.device.type != "cuda":
        raise ValueError(f"fused_self_attention_bwd: unsupported device {q.device}")
    if not (q.shape == k.shape == v.shape == g.shape and q.dim() == 4):
        raise ValueError(f"fused_self_attention_bwd: q/k/v/g must share one (B, H, S, D) shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(g.shape)}")
    if not (q.dtype == k.dtype == v.dtype == g.dtype and q.dtype in _DTYPES):
        raise ValueError(f"fused_self_attention_bwd: dtype {q.dtype}/{k.dtype}/{v.dtype}/"
                         f"{g.dtype}; the kernel takes one of bfloat16, float32")
    if not (q.device == k.device == v.device == g.device):
        raise ValueError("fused_self_attention_bwd: q/k/v/g on different devices")
    for t in (q, k, v, g):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("fused_self_attention_bwd: q/k/v/g must be contiguous and 16-byte "
                             "aligned")
    plan = bwd_launch_plan(q.shape, q.dtype)
    q, k, v, g = (launch.pad_to(t, plan.padded) for t in (q, k, v, g))
    s, dp = q.shape[-2:]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    scratch = torch.empty(bwd_scratch_floats(plan, s), dtype=torch.float32, device=q.device)
    lib = _bwd_lib(plan.library)
    row = s * dp * q.element_size()  # bytes of one of the B*H rows
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for start, stop in plan.slices:
            at = start * row
            rc = lib.fused_attention_bwd(
                *(t.data_ptr() + at for t in (q, k, v, g, dq, dk, dv)), scratch.data_ptr(),
                stop - start, s, dp, float(plan.width**-0.5), _DTYPES[q.dtype], stream)
            build.check(lib, rc, "fused_self_attention_bwd")
            fused_self_attention_bwd.launches += 1
            fused_self_attention_bwd.launches_float32 += int(q.dtype == torch.float32)
    if dp == plan.width:
        return dq, dk, dv
    return tuple(t[..., :plan.width].contiguous() for t in (dq, dk, dv))


def fused_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bf16_probs: bool = False) -> torch.Tensor:
    """(B, H, S, D) self-attention, softmax scale 1/sqrt(D), output in V's dtype;
    ``bf16_probs`` selects the fast mode. Differentiable: with grad mode on and an input that
    requires grad, the call goes through :class:`FusedSelfAttention`.

    CUDA: contiguous bf16 or float32 tensors of one shape, S % 64 == 0, any D <= 160 and any
    B*H (:func:`launch_plan`): a D that is not a multiple of 8 is zero-padded, the scale kept at
    the true D, and the output sliced back; B*H past 65535 takes one launch a slice. Counts each
    launch in ``fused_self_attention.launches``, in float32 in
    ``fused_self_attention.launches_float32`` and, in the fast mode, in
    ``fused_self_attention.launches_bf16_probs``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FusedSelfAttention.apply(q, k, v, bf16_probs)
    return _dispatch(q, k, v, bf16_probs)


def _dispatch(q, k, v, bf16_probs: bool) -> torch.Tensor:
    """The plain version on a CPU tensor; on a CUDA tensor the kernel's launch, or a raise."""
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
            rc = lib.fused_attention_fwd(q.data_ptr() + at, k.data_ptr() + at, v.data_ptr() + at,
                                         out.data_ptr() + at, stop - start, s, dp,
                                         float(plan.width**-0.5), _DTYPES[q.dtype],
                                         int(bf16_probs), stream)
            build.check(lib, rc, "fused_self_attention")
            fused_self_attention.launches += 1
            fused_self_attention.launches_float32 += int(q.dtype == torch.float32)
            fused_self_attention.launches_bf16_probs += int(bf16_probs)
    return out if dp == plan.width else out[..., :plan.width].contiguous()


fused_self_attention.launches = 0
fused_self_attention.launches_float32 = 0
fused_self_attention.launches_bf16_probs = 0
fused_self_attention_bwd.launches = 0
fused_self_attention_bwd.launches_float32 = 0
