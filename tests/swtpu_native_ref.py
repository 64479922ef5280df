"""swtpu's native host library for the port's tests, built where no other
process writes it.

swtpu builds ``libswtpu_native.so`` in place beside its source
(``swtpu/runtime/native.py:_build``), so a process that loads it while
another writes it gets no library and takes swtpu's numpy fallback for the
rest of its life.  Tests that run in parallel workers hit that race.  This
module compiles swtpu's own source (read, never written) with swtpu's flags
into the port's build directory, through a file of its own and
``os.replace``, under a hash of the source and flags, and declares it with
swtpu's ``_declare``.  A test sets it as ``swtpu.runtime.native._lib`` with
``monkeypatch`` (``use_swtpu_native``), so swtpu's packers run on the same
C++ they would load themselves.
"""

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import swtpu.runtime.native as ref_native
from swtpu_torch.ops._build import build_dir

# swtpu's g++ flags (swtpu/runtime/native.py:_build)
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(Path(ref_native._SRC).read_bytes())
    return build_dir() / f"libswtpu_ref_native_{h.hexdigest()[:16]}.so"


@functools.cache
def library() -> ctypes.CDLL:
    """swtpu's native library, compiled once per source; raises if g++ fails
    (a test that needs it must not pass on the numpy fallback)."""
    path = library_path()
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        try:
            subprocess.run(
                ["g++", *FLAGS, str(ref_native._SRC), "-o", str(tmp)],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, path)  # atomic against a concurrent build
        finally:
            tmp.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(path))
    ref_native._declare(lib)
    return lib


def use_swtpu_native(monkeypatch) -> ctypes.CDLL:
    """Point swtpu's native module at ``library()`` for one test."""
    lib = library()
    monkeypatch.setattr(ref_native, "_lib", lib)
    return lib
