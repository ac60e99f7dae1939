"""Build the CUDA sources under ``diffsim_tpu_torch/csrc`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared library (the
``csrc/*.cuh`` headers are included by the sources):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

into ``diffsim_tpu_torch/_build/`` (git-ignored), named by a hash of the source and the headers
so an edited source or header is rebuilt. Libraries are loaded with ``ctypes``. Nothing here runs
at import time: the CPU tests import every module of the port, and a machine without a card may
have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("fused_attention", "fused_attention_bwd", "geglu_ff", "fused_readout",
           "fused_readout_f32", "streaming_attention", "streaming_attention_wide")
# the previous designs of K1 (bf16 and float32) and K4 (attention_v2; the wide heads'
# streaming_attention_wide_v1), K2 and K3 (both dtypes) and K1's backward
# (fused_attention_bwd_v1), built only by chip_smoke.py to time the kernels against them
BASELINES = ("attention_v2", "geglu_ff_v2", "fused_readout_v2", "streaming_attention_wide_v1",
             "fused_attention_bwd_v1")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                                    "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit "
                       "(PATH or CUDA_HOME)")


def _lib_path(name: str) -> str:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    digest = digest.hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(names=SOURCES) -> dict[str, str]:
    """Compile every source in ``names`` whose library is missing, one nvcc process per
    source, all started together. Returns {name: ptxas report}, each led by the line
    "nvcc <name>.cu built in <s> s" (the wall time of its process); raises on a failed build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    reports, failed = {}, []

    def finish(name, proc):  # each process's output read on a thread of its own, to its end
        log, _ = proc.communicate()
        reports[name] = f"nvcc {name}.cu built in {time.perf_counter() - t0:.1f} s\n{log}"

    threads = [threading.Thread(target=finish, args=(name, proc))
               for name, (proc, _, _) in procs.items()]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    for name, (proc, tmp, out) in procs.items():
        log = reports[name]
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def build_on_local_leader() -> None:
    """``build`` once a host in a process group: local rank 0 compiles while the host's other
    ranks wait at a barrier, so N fresh ranks do not run N copies of nvcc. Every rank raises if
    the leader's build failed."""
    import torch.distributed as dist

    error = None
    if int(os.environ.get("LOCAL_RANK", dist.get_rank())) == 0:
        try:
            build()
        except RuntimeError as e:
            error = e
    ok = [None] * dist.get_world_size()
    dist.all_gather_object(ok, error is None)
    if error is not None:
        raise error
    if not all(ok):
        raise RuntimeError("CUDA kernel build failed on another rank's host leader")


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(_lib_path(name))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({lib.kernel_error_string(rc).decode()})")
