"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` compile with nvcc, one process per source, all
started together, and link into one shared library with a plain C
interface, loaded with ctypes.  The build happens at first use,
into ``build_dir()`` (``build/swtpu_torch/`` in a checkout), under a name that
carries a hash of the sources and flags, so an edited source rebuilds and
no binary is ever committed.  A missing nvcc or a failed build raises with
the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
SOURCES = ("stream_wavefront.cu", "column.cu", "lane.cu", "microbench.cu")
HEADERS = ("packed16.cuh",)  # included by the sources: part of the hash
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def build_dir() -> Path:
    """Where the library is built: $SWTPU_TORCH_BUILD_DIR if set; else
    ``build/swtpu_torch/`` at the root of the checkout the package runs
    from; else, for an installed package (whose prefix may be shared or
    read-only), ``swtpu_torch/`` under the user's cache directory."""
    if os.environ.get("SWTPU_TORCH_BUILD_DIR"):
        return Path(os.environ["SWTPU_TORCH_BUILD_DIR"])
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").is_file():
        return root / "build" / "swtpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "swtpu_torch"


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return build_dir() / f"libswtpu_torch_{h.hexdigest()[:16]}.so"


def build_log_path() -> Path:
    """nvcc's output (ptxas register and spill report) of the last build."""
    return library_path().with_suffix(".log")


def _build(lib: Path) -> None:
    """Compile every source to an object in parallel, then link."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [lib.with_name(f"{tag}.{Path(s).stem}.o") for s in SOURCES]
    cmds = [
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
        for s, o in zip(SOURCES, objs)
    ]
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    tmp = lib.with_name(f"{tag}.tmp.so")
    link = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
    failed = [(c, p.returncode, o) for c, p, o in zip(cmds, procs, outs) if p.returncode]
    if not failed:
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        outs.append(res.stdout)
        if res.returncode:
            failed.append((link, res.returncode, res.stdout))
    lib.with_suffix(".log").write_text("".join(outs))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        cmd, rc, out = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
    os.replace(tmp, lib)  # atomic against a concurrent build


def load_library() -> ctypes.CDLL:
    """The kernel library, built first if its sources changed."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.swtpu_stream_wavefront.restype = ctypes.c_int
            lib.swtpu_stream_wavefront.argtypes = [
                *[ctypes.c_void_p] * 3, *[ctypes.c_int] * 9, ctypes.c_void_p,
                *[ctypes.c_int] * 3,
            ]
            lib.swtpu_stream_chained.restype = ctypes.c_int
            lib.swtpu_stream_chained.argtypes = [
                *[ctypes.c_void_p] * 9, *[ctypes.c_int] * 7, ctypes.c_void_p,
                *[ctypes.c_int] * 3,
            ]
            lib.swtpu_stream_chain.restype = ctypes.c_int
            lib.swtpu_stream_chain.argtypes = [
                *[ctypes.c_void_p] * 4, *[ctypes.c_int] * 8, ctypes.c_void_p,
                *[ctypes.c_int] * 5,
            ]
            lib.swtpu_stream_kernel_info.restype = ctypes.c_int
            lib.swtpu_stream_kernel_info.argtypes = [
                *[ctypes.c_int] * 4, ctypes.POINTER(ctypes.c_int),
            ]
            lib.swtpu_column_scores.restype = ctypes.c_int
            lib.swtpu_column_scores.argtypes = [
                *[ctypes.c_void_p] * 3, *[ctypes.c_int] * 9, ctypes.c_void_p,
            ]
            lib.swtpu_column_kernel_info.restype = ctypes.c_int
            lib.swtpu_column_kernel_info.argtypes = [
                *[ctypes.c_int] * 3, ctypes.POINTER(ctypes.c_int),
            ]
            lib.swtpu_column_chained.restype = ctypes.c_int
            lib.swtpu_column_chained.argtypes = [
                *[ctypes.c_void_p] * 8, *[ctypes.c_int] * 8, ctypes.c_void_p,
            ]
            lib.swtpu_lane_scores.restype = ctypes.c_int
            lib.swtpu_lane_scores.argtypes = [
                *[ctypes.c_void_p] * 5, *[ctypes.c_int] * 6, ctypes.c_void_p,
            ]
            lib.swtpu_microbench_ops.restype = ctypes.c_int
            lib.swtpu_microbench_ops.argtypes = [
                *[ctypes.c_void_p] * 2, *[ctypes.c_int] * 4, ctypes.c_void_p,
            ]
            lib.swtpu_stream_ablate.restype = ctypes.c_int
            lib.swtpu_stream_ablate.argtypes = [
                *[ctypes.c_void_p] * 3, *[ctypes.c_int] * 4, ctypes.c_void_p,
            ]
            lib.swtpu_cuda_error_string.restype = ctypes.c_char_p
            lib.swtpu_cuda_error_string.argtypes = [ctypes.c_int]
            _lib = lib
        return _lib
