"""Build and bind the port's CUDA kernels.

Every `csrc/*.cu` source is compiled by `nvcc` for `sm_90a` (one process per
source, all started together) and linked into one shared library under
`build/repro_torch/<source hash>/` at the repository root. The library has a
plain C interface and is loaded with `ctypes`, so the build never includes
PyTorch's headers. The build runs at first use and is keyed on a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # a, b, b2, c, ws, E, M, N, K, bm, bn, split, stages, dtype, epilogue, act, stream
    "rt_expert_gemm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # a, bq, bs, b2q, b2s, c, ws, E, M, N, K, bm, bn, split, stages, dtype, epilogue, act, stream
    "rt_expert_gemm_q": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P),
    # a, bq, bs, b2q, b2s, c, ws, E, M, N, K, group, bm, bn, split, stages, dtype, epilogue,
    # act, stream
    "rt_expert_gemm_q4": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          _I, _P),
    # z, out, rows, L, dtype (sparsemax.DTYPES), stream
    "rt_sparsemax": (_P, _P, _I, _I, _I, _P),
    # q, k, v, o, B, S, H, KH, D, window, cap, causal, dtype, stream
    "rt_flash_prefill": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P),
    # q, k, v, slot_pos, pos, o, B, S, H, KH, D, window, cap, splits, dtype, stream
    "rt_flash_decode": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P),
    # q, kp, vp, table, pos, o, B, Mp, page, P1, H, KH, D, window, cap, splits, dtype, stream
    "rt_flash_decode_paged": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                              _I, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; return
    the library's path. The compiler's `-Xptxas -v` report (registers,
    shared memory, spills per kernel) is kept beside it as `build.log`."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT))
    try:
        procs = []
        t0 = time.perf_counter()
        for src in sorted(CSRC.glob("*.cu")):
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        log, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            # all compile at once, so this is when each one had finished
            log.append(f"== {src.name} (done {time.perf_counter() - t0:.1f} s after the start)\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed for {failed}:\n" + "\n".join(log)
            )
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(work / LIB_NAME),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (work / "build.log").write_text("\n".join(log))
        try:
            os.replace(work, out_dir)    # atomic publish of the whole build
        except OSError:
            if not lib_path.exists():   # a concurrent build won the rename
                raise
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def build_log() -> str:
    """The compiler's report of the current build (built on first use)."""
    return (build().parent / "build.log").read_text()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.rt_error_string.argtypes = [ctypes.c_int]
            lib.rt_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(name: str, code: int) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if code != 0:
        msg = library().rt_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on `t`'s device, as the C entries take it."""
    return torch.cuda.current_stream(t.device).cuda_stream
