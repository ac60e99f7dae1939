"""K2 ``fused_geglu_ff``: the transformer GEGLU feed-forward.

Replaces the TPU kernel ``diffsim_tpu/ops/pallas/ff.py:fused_geglu_ff``. The CUDA kernels are
``csrc/geglu_ff.cu`` (design and bound in its header): ``wgmma`` GEMMs in bf16, 3xTF32
``mma.sync`` GEMMs in float32. Weights are in the nn.Linear (out, in) layout: W1 (8C, C),
W2 (C, 4C). On a CPU tensor the wrapper runs :func:`fused_geglu_ff_plain`; on a CUDA tensor it
launches the kernels or raises. Every shape the route admits is launched (:func:`launch_plan`):
a C off the kernels' granule of 32 zero-padded with the weights, and N past the grid's 65535
64-row tiles in slices.

Under grad the call goes through :class:`FusedGegluFF`, whose backward
:func:`fused_geglu_ff_bwd_plain` ports the TPU kernel's custom VJP (``_fused_bwd``,
``diffsim_tpu/ops/pallas/ff.py:107-132``), XLA math there and ``torch.matmul`` here.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from diffsim_tpu_torch.ops.kernels import build, launch, routes

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
GRANULE = 32  # the kernels' C granule (kernel_takes)
MAX_ROWS = 64 * launch.MAX_GRID_ROWS  # rows a launch: 65535 tiles of 64 rows


def fused_geglu_ff_plain(x, w1, b1, w2, b2) -> torch.Tensor:
    """The TPU kernel's arithmetic: f32 accumulation, f32 bias and exact-erf GEGLU epilogue,
    the intermediate cast to x's dtype, f32 output bias, output in x's dtype."""
    hg = F.linear(x.float(), w1.float(), b1.float())
    h, g = hg.chunk(2, dim=-1)
    y = (h * (0.5 * g * (1.0 + torch.erf(g * 0.7071067811865476)))).to(x.dtype)
    return F.linear(y.float(), w2.float(), b2.float()).to(x.dtype)


def fused_geglu_ff_bwd_plain(x, w1, b1, w2, b2, g):
    """The TPU kernel's backward (``_fused_bwd``): the hidden projection recomputed in f32, the
    erf-form GELU and its derivative Phi(g) + g * pdf(g), the intermediate cast to x's dtype
    where the forward casts it, f32 products, each gradient in its input's dtype. Weights in the
    nn.Linear layout, so dW1 is (8C, C) and dW2 (C, 4C)."""
    g32 = g.float()
    hg = F.linear(x.float(), w1.float(), b1.float())
    h, gate = hg.chunk(2, dim=-1)
    phi = 0.5 * (1.0 + torch.erf(gate * 0.7071067811865476))
    gelu_g = gate * phi
    y = (h * gelu_g).to(x.dtype)
    dw2 = torch.matmul(g32.t(), y.float())
    db2 = g32.sum(dim=0)
    dy = torch.matmul(g32, w2.float())
    pdf = torch.exp(-0.5 * gate * gate) * 0.3989422804014327
    dhg = torch.cat([dy * gelu_g, dy * h * (phi + gate * pdf)], dim=-1)
    dx = torch.matmul(dhg, w1.float())
    dw1 = torch.matmul(dhg.t(), x.float())
    db1 = dhg.sum(dim=0)
    return (dx.to(x.dtype), dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
            db2.to(b2.dtype))


class FusedGegluFF(torch.autograd.Function):
    """K2 under autograd: the forward dispatches as :func:`fused_geglu_ff` does without grad,
    the backward is :func:`fused_geglu_ff_bwd_plain`."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _dispatch(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        return fused_geglu_ff_bwd_plain(*ctx.saved_tensors, g)


def kernel_takes(n: int, c: int) -> bool:
    """The shape contract of the CUDA kernels, both dtypes: C % 32 == 0 (the bf16 kernels read
    64-column k panels, TMA zero-filling the last half panel when C % 64 == 32, the float32
    kernels 32-column ones; y has 4C columns, a multiple of their 64-column tiles) and
    0 < ceil(N / 64) <= 65535; any N in that range, the kernels zero-filling the rows past N of
    their 128-row tiles."""
    return c > 0 and c % 32 == 0 and 0 < n and (n + 63) // 64 <= 65535


def launch_plan(shape, dtype: torch.dtype) -> launch.LaunchPlan:
    """K2's launches for x of shape (N, C) in ``dtype``: C zero-padded to a multiple of 32 (a C
    past the route's 640 only at C % 32 == 0, unpadded, as the kernels take it), one launch a
    slice of at most 65535 x 64 rows. Raises ValueError for any other C, or off bfloat16 and
    float32."""
    n, c = shape
    if dtype not in _DTYPES or c <= 0 or (c % GRANULE and c > routes.MAX_FUSED_DIM):
        raise ValueError(f"fused_geglu_ff: shape {(n, c)} {dtype} not supported by the kernel "
                         f"(bfloat16 or float32, C <= {routes.MAX_FUSED_DIM} or C % 32 == 0)")
    return launch.LaunchPlan("geglu_ff", c, launch.padded_width(c, GRANULE),
                             launch.row_slices(n, MAX_ROWS))


def pad_weights(w1, b1, w2, b2, cp: int):
    """The weights of a C-wide feed-forward (nn.Linear layout) zero-padded to width ``cp``: W1
    (8C, C) into (8cp, cp) with its h rows at [0, 4C) and its gate rows at [4cp, 4cp + 4C), apart,
    since the kernels split the hidden layer at 4cp (as :func:`fused_geglu_ff_plain`'s
    ``chunk(2)`` does); b1 the same; W2 (C, 4C) into (cp, 4cp) at [0, C) x [0, 4C); b2 into (cp).
    A padded hidden unit has h = 0 and gate 0, gelu(0) = 0, and a zero column of W2, so it adds
    nothing; the padded output columns are 0 and are sliced off. The inputs themselves when
    cp == C."""
    c = w2.shape[0]
    if cp == c:
        return w1, b1, w2, b2
    hid, hp = 4 * c, 4 * cp
    w1p, b1p = w1.new_zeros((8 * cp, cp)), b1.new_zeros(8 * cp)
    for half in (0, 1):
        w1p[half * hp:half * hp + hid, :c] = w1[half * hid:(half + 1) * hid]
        b1p[half * hp:half * hp + hid] = b1[half * hid:(half + 1) * hid]
    w2p = w2.new_zeros((cp, hp))
    w2p[:c, :hid] = w2
    return w1p, b1p, w2p, launch.pad_to(b2, cp)


def _lib(name: str) -> ctypes.CDLL:
    lib = build.library(name)
    if lib.geglu_ff_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.geglu_ff_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
        lib.geglu_ff_fwd.restype = i
    return lib


def fused_geglu_ff(x, w1, b1, w2, b2) -> torch.Tensor:
    """x (N, C) -> (N, C). CUDA: contiguous tensors of one dtype (bfloat16 or float32), any
    C <= 640 and any N (:func:`launch_plan`; a wider C at C % 32 == 0): a C off the kernels'
    granule of 32 is zero-padded with the weights (:func:`pad_weights`, on each call) and the
    output sliced back; N past 65535 x 64 rows takes one launch a slice. A launch runs the two
    GEMM kernels and counts one in ``fused_geglu_ff.launches`` (and, in float32, in
    ``fused_geglu_ff.launches_float32``). Differentiable through :class:`FusedGegluFF`."""
    tensors = (x, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return FusedGegluFF.apply(*tensors)
    return _dispatch(*tensors)


def _dispatch(x, w1, b1, w2, b2) -> torch.Tensor:
    """The plain version on a CPU tensor; on a CUDA tensor the kernels' launch, or a raise."""
    if x.device.type == "cpu":
        return fused_geglu_ff_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_geglu_ff: unsupported device {x.device}")
    n, c = x.shape
    shapes = {"w1": (8 * c, c), "b1": (8 * c,), "w2": (c, 4 * c), "b2": (c,)}
    args = {"w1": w1, "b1": b1, "w2": w2, "b2": b2}
    for name, t in args.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"fused_geglu_ff: {name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
    tensors = [x, *args.values()]
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in tensors):
        raise ValueError("fused_geglu_ff: x and the weights must share one dtype of "
                         "bfloat16, float32")
    if any(t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError("fused_geglu_ff: tensors must be contiguous, 16-byte aligned and on "
                         "one device")
    plan = launch_plan(x.shape, x.dtype)
    x = launch.pad_to(x, plan.padded)
    w1, b1, w2, b2 = pad_weights(w1, b1, w2, b2, plan.padded)
    cp = plan.padded
    y = torch.empty((min(n, MAX_ROWS), 4 * cp), dtype=x.dtype, device=x.device)  # per slice
    out = torch.empty_like(x)
    row = cp * x.element_size()  # bytes of one row of x and out
    lib = _lib(plan.library)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for start, stop in plan.slices:
            rc = lib.geglu_ff_fwd(x.data_ptr() + start * row, w1.data_ptr(), b1.data_ptr(),
                                  w2.data_ptr(), b2.data_ptr(), y.data_ptr(),
                                  out.data_ptr() + start * row, stop - start, cp,
                                  _DTYPES[x.dtype], stream)
            build.check(lib, rc, "fused_geglu_ff")
            fused_geglu_ff.launches += 1
            fused_geglu_ff.launches_float32 += int(x.dtype == torch.float32)
    return out if cp == c else out[:, :c].contiguous()


fused_geglu_ff.launches = 0
fused_geglu_ff.launches_float32 = 0
