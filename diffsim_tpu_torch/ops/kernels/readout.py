"""K3 ``cross_self_partials`` / ``fused_direction_score``: the fused DiffSim readout.

Replaces the TPU kernel ``diffsim_tpu/ops/pallas/readout.py:cross_self_partials`` and its
caller ``fused_direction_score``. For each row of N = P*B*H the kernel computes the cross and
the self attention of the same queries and reduces them at once to the similarity partials
sum(o1*o2), sum(o1^2), sum(o2^2) (cosine) or sum((o1-o2)^2) (mse), so neither attention output
is written to device memory. The CUDA kernels are ``csrc/fused_readout.cu`` (bf16, ``wgmma``)
and ``csrc/fused_readout_f32.cu`` (float32, 3xTF32 ``mma.sync``), each its own library with
the entry point ``fused_readout_fwd`` (design and bound in their headers); each writes one f32
triple per (row, 64-row q tile), and torch sums them in a fixed order, so scores repeat exactly
from run to run. On a CPU tensor the wrapper runs :func:`cross_self_partials_plain`; on a CUDA
tensor it launches the kernel or raises. Every shape the route admits is launched
(:func:`launch_plan`): a D off the kernels' granule of 8 zero-padded, the scale kept at the true
D, and N past the grid's 65535 in slices.
"""

from __future__ import annotations

import ctypes

import torch

from diffsim_tpu_torch.ops.kernels import build, launch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIBRARIES = {torch.float32: "fused_readout_f32", torch.bfloat16: "fused_readout"}
_COS_EPS = 1e-8
_Q_TILE = 64
MAX_DIM = 128  # the route's widest head (routes.use_fused_readout) and the kernels'


def _partials(o1: torch.Tensor, o2: torch.Tensor, mse: bool):
    if mse:
        d = o1 - o2
        return (d * d).sum(dim=(-2, -1)), torch.zeros_like(d[:, 0, 0]), torch.zeros_like(d[:, 0, 0])
    return ((o1 * o2).sum(dim=(-2, -1)), (o1 * o1).sum(dim=(-2, -1)),
            (o2 * o2).sum(dim=(-2, -1)))


def cross_self_partials_plain(q, k_cross, v_cross, k_self, v_self, mse: bool = False,
                              scale: float | None = None):
    """The TPU kernel's arithmetic on (N, S, D) rows: f32 logits times the scale, a softmax
    normalised before PV, probabilities cast to V's dtype, f32 products, f32 partials. Returns
    three (N,) f32 tensors (dot or squared difference, |cross|^2, |self|^2). ``scale`` defaults
    to 1/sqrt(D); a caller that zero-pads the head passes the unpadded width's."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf = q.float()

    def attn(k, v):
        w = torch.softmax(torch.matmul(qf, k.float().transpose(-1, -2)) * scale, dim=-1)
        return torch.matmul(w.to(v.dtype).float(), v.float())

    return _partials(attn(k_cross, v_cross), attn(k_self, v_self), mse)


def _lib(name: str) -> ctypes.CDLL:
    lib = build.library(name)
    if lib.fused_readout_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_readout_fwd.argtypes = [p, p, p, p, p, p, i, i, i, ctypes.c_float, i, i, p]
        lib.fused_readout_fwd.restype = i
    return lib


def launch_plan(shape, dtype: torch.dtype) -> launch.LaunchPlan:
    """K3's launches for (N, S, D) rows in ``dtype``: the library of the dtype, D zero-padded to a
    multiple of 8 (at most 128), one launch a slice of at most 65535 rows. Raises ValueError
    outside S % 64 == 0, 0 < D <= 128, or off bfloat16 and float32."""
    n, s, d = shape
    if dtype not in _DTYPES or s % _Q_TILE or not 0 < d <= MAX_DIM:
        raise ValueError(f"cross_self_partials: shape {tuple(shape)} {dtype} not supported by the "
                         f"kernel (bfloat16 or float32, S % 64 == 0, D <= {MAX_DIM})")
    return launch.LaunchPlan(_LIBRARIES[dtype], d, launch.padded_width(d, launch.HEAD_GRANULE),
                             launch.row_slices(n))


def cross_self_partials(q, k_cross, v_cross, k_self, v_self, mse: bool = False):
    """(N, S, D) rows -> three (N,) f32 partial sums, as :func:`cross_self_partials_plain`.

    CUDA: contiguous bf16 or float32 tensors of one shape, S % 64 == 0, any D <= 128 and any N
    (:func:`launch_plan`): a D that is not a multiple of 8 is zero-padded (zero columns add nothing
    to a logit and give zero output columns, so nothing to a partial), the scale kept at the true D;
    N past 65535 takes one launch a slice, each writing its rows of one partials buffer before the
    fixed-order sum. Counts each launch in ``cross_self_partials.launches`` (and, in float32, in
    ``cross_self_partials.launches_float32``). Not differentiable, as the TPU kernel is not: under
    grad, on inputs that require it, the call raises."""
    tensors = (q, k_cross, v_cross, k_self, v_self)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("cross_self_partials has no backward (the TPU kernel defines no VJP "
                           "either): call it under torch.no_grad() or on detached inputs")
    if q.device.type == "cpu":
        return cross_self_partials_plain(q, k_cross, v_cross, k_self, v_self, mse)
    if q.device.type != "cuda":
        raise ValueError(f"cross_self_partials: unsupported device {q.device}")
    if q.dim() != 3 or any(t.shape != q.shape for t in tensors):
        raise ValueError("cross_self_partials: q and the four K/V must share one (N, S, D) "
                         f"shape, got {[tuple(t.shape) for t in tensors]}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError("cross_self_partials: tensors must share one dtype of bfloat16, "
                         "float32")
    if any(t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError("cross_self_partials: tensors must be contiguous, 16-byte aligned and "
                         "on one device")
    plan = launch_plan(q.shape, q.dtype)
    tensors = [launch.pad_to(t, plan.padded) for t in tensors]
    n, s, dp = tensors[0].shape
    lib = _lib(plan.library)
    row = s * dp * q.element_size()  # bytes of one of the N rows
    # one buffer for every slice's (rows, S / 64, 3) partials: the kernels store single floats
    out = torch.empty((n, s // _Q_TILE, 3), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for start, stop in plan.slices:
            rc = lib.fused_readout_fwd(*(t.data_ptr() + start * row for t in tensors),
                                       out[start:stop].data_ptr(), stop - start, s, dp,
                                       float(plan.width**-0.5), _DTYPES[q.dtype], int(mse),
                                       stream)
            build.check(lib, rc, "cross_self_partials")
            cross_self_partials.launches += 1
            cross_self_partials.launches_float32 += int(q.dtype == torch.float32)
    sums = out.sum(dim=1)
    return sums[:, 0], sums[:, 1], sums[:, 2]


cross_self_partials.launches = 0
cross_self_partials.launches_float32 = 0


def _direction_score(partials, qa, ka, va, kb, vb, similarity: str) -> torch.Tensor:
    p, b, h, s, d = qa.shape

    def flat(x):
        return x.reshape(p * b * h, s, d).contiguous()

    dot, n1, n2 = partials(flat(qa), flat(kb), flat(vb), flat(ka), flat(va),
                           mse=(similarity == "mse"))

    def per_pair(x):
        return x.reshape(p, b * h).sum(dim=1)

    if similarity == "mse":
        return per_pair(dot) / (b * h * s * d)
    den = (torch.clamp(torch.sqrt(per_pair(n1)), min=_COS_EPS)
           * torch.clamp(torch.sqrt(per_pair(n2)), min=_COS_EPS))
    return per_pair(dot) / den


def fused_direction_score(qa, ka, va, kb, vb, similarity: str = "cosine") -> torch.Tensor:
    """One direction of the DiffSim readout for (P, B, H, S, D) taps: the similarity between
    attn(qa, kb, vb) and attn(qa, ka, va), flattened per pair, (P,) f32. The cosine epilogue
    (``max(sqrt(sum), 1e-8)`` over each pair's B*H rows) runs in torch, as in the JAX
    package."""
    return _direction_score(cross_self_partials, qa, ka, va, kb, vb, similarity)


def fused_direction_score_plain(qa, ka, va, kb, vb, similarity: str = "cosine") -> torch.Tensor:
    """:func:`fused_direction_score` on the kernel's plain version."""
    return _direction_score(cross_self_partials_plain, qa, ka, va, kb, vb, similarity)
