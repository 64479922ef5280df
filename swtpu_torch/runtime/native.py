"""ctypes bindings for the native host runtime (``swtpu_native.cpp``).

The port's copy of ``swtpu.runtime.native``: the same C++ source, the same
entry points, the same bytes.  The reference's host data path is native C
(FASTA -> 2-bit packed cachelines,
capi_sample_aligner/software-C,C++/include/aligner_Header.c); the port
keeps the same split: Python orchestrates, C++ does the byte crunching.

The library is built on demand with g++ into ``build_dir()`` (the kernels'
build directory, ``swtpu_torch.ops._build``) under a name that carries a
hash of the source, never next to the source, so an edited source rebuilds
and no binary is ever committed.  Without g++ every entry point's caller
takes its pure-numpy fallback (``native_available()`` is then False), as
swtpu's do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from swtpu_torch.ops._build import build_dir

_SRC = Path(__file__).parent / "swtpu_native.cpp"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    """Where the native library is built: named by a hash of its source
    and flags."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return build_dir() / f"libswtpu_native_{h.hexdigest()[:16]}.so"


def _build() -> Optional[ctypes.CDLL]:
    """Load the library, compiling it first if it is not built; None when
    g++ is missing or fails."""
    global _build_failed
    lib = library_path()
    if not lib.exists():
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        try:
            lib.parent.mkdir(parents=True, exist_ok=True)
            subprocess.run(
                ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, lib)  # atomic against a concurrent build
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
            _build_failed = True
            return None
    return ctypes.CDLL(str(lib))


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is None and not _build_failed:
            lib = _build()
            if lib is not None:
                _declare(lib)
            _lib = lib
    return _lib


def _declare(lib: ctypes.CDLL) -> None:
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i8p = ctypes.POINTER(ctypes.c_int8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.swtpu_fasta_index.restype = ctypes.c_int64
    lib.swtpu_fasta_index.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, i64p, i64p, i64p, i64p, i64p,
        ctypes.c_int64,
    ]
    lib.swtpu_encode_records.restype = None
    lib.swtpu_encode_records.argtypes = [
        ctypes.c_char_p, i64p, i64p, ctypes.c_int64, i8p, ctypes.c_int64,
        ctypes.c_int8, i32p, ctypes.c_int32,
    ]
    lib.swtpu_pack_bucket.restype = ctypes.c_int64
    lib.swtpu_pack_bucket.argtypes = [
        i8p, i32p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        i8p, ctypes.c_int64, ctypes.c_int8, i32p, i32p, ctypes.c_int64,
    ]
    lib.swtpu_pack_2bit.restype = None
    lib.swtpu_pack_2bit.argtypes = [i8p, ctypes.c_int64, u8p]
    lib.swtpu_unpack_2bit.restype = None
    lib.swtpu_unpack_2bit.argtypes = [u8p, ctypes.c_int64, i8p]
    lib.swtpu_pack_wire.restype = None
    lib.swtpu_pack_wire.argtypes = [
        i8p, ctypes.c_int64, ctypes.c_int64, u8p, u8p,
    ]
    lib.swtpu_plan_streams.restype = ctypes.c_int64
    lib.swtpu_plan_streams.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i32p, i64p,
    ]
    lib.swtpu_fill_streams.restype = None
    lib.swtpu_fill_streams.argtypes = [
        i8p, i32p, ctypes.c_int64, ctypes.c_int64, i32p, i64p,
        ctypes.c_int64, ctypes.c_int8, i8p, ctypes.c_int64,
    ]


def native_available() -> bool:
    return _get_lib() is not None


def _as(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class NativePacker:
    """Fast FASTA -> dense encoded matrix pipeline (C++ under the hood)."""

    def __init__(self, strict: bool = True):
        self.strict = strict
        self._lib = _get_lib()
        if self._lib is None:
            raise RuntimeError("native library unavailable (no g++?)")

    def index_fasta(self, text: bytes) -> Tuple[List[str], np.ndarray, np.ndarray, np.ndarray]:
        """Returns (names, rec_start, rec_end, seq_lens) for a FASTA blob."""
        cap = max(16, text.count(b">") + 1)
        name_off = np.zeros(cap, np.int64)
        name_len = np.zeros(cap, np.int64)
        rec_start = np.zeros(cap, np.int64)
        rec_end = np.zeros(cap, np.int64)
        seq_len = np.zeros(cap, np.int64)
        n = self._lib.swtpu_fasta_index(
            text, len(text), _as(name_off, ctypes.c_int64),
            _as(name_len, ctypes.c_int64), _as(rec_start, ctypes.c_int64),
            _as(rec_end, ctypes.c_int64), _as(seq_len, ctypes.c_int64), cap,
        )
        names = [
            text[name_off[i]: name_off[i] + name_len[i]].decode("ascii", "replace")
            for i in range(n)
        ]
        return names, rec_start[:n], rec_end[:n], seq_len[:n]

    def encode(
        self, text: bytes, rec_start: np.ndarray, rec_end: np.ndarray,
        width: int, pad_code: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Encode record spans into a dense [n, width] int8 matrix + lengths."""
        n = len(rec_start)
        out = np.empty((n, width), np.int8)
        lens = np.empty(n, np.int32)
        rs = np.ascontiguousarray(rec_start, np.int64)
        re_ = np.ascontiguousarray(rec_end, np.int64)
        self._lib.swtpu_encode_records(
            text, _as(rs, ctypes.c_int64), _as(re_, ctypes.c_int64), n,
            _as(out, ctypes.c_int8), width, pad_code,
            _as(lens, ctypes.c_int32), 1 if self.strict else 0,
        )
        return out, lens

    def pack_bucket(
        self, src: np.ndarray, lens: np.ndarray, assign: np.ndarray,
        bucket: int, dst_width: int, pad_code: int, max_rows: int,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        src = np.ascontiguousarray(src, np.int8)
        lens = np.ascontiguousarray(lens, np.int32)
        assign = np.ascontiguousarray(assign, np.int32)
        dst = np.full((max_rows, dst_width), pad_code, np.int8)
        ids = np.full(max_rows, -1, np.int32)
        out_lens = np.zeros(max_rows, np.int32)
        n = self._lib.swtpu_pack_bucket(
            _as(src, ctypes.c_int8), _as(lens, ctypes.c_int32),
            _as(assign, ctypes.c_int32), src.shape[0], bucket, src.shape[1],
            _as(dst, ctypes.c_int8), dst_width, pad_code,
            _as(ids, ctypes.c_int32), _as(out_lens, ctypes.c_int32), max_rows,
        )
        return dst, ids, out_lens, int(n)

    def plan_streams(
        self, lens: np.ndarray, n_streams: int, drain: int
    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Greedy shortest-stream assignment (the PrioEncoder dispatch,
        ScoreBank/PrioEncoder.v:16-22) for a ragged read set.

        Returns (emit_stream [n] int32, emit_step [n] int64, max_fill)."""
        lens = np.ascontiguousarray(lens, np.int32)
        n = len(lens)
        emit_stream = np.zeros(n, np.int32)
        emit_step = np.zeros(n, np.int64)
        max_fill = self._lib.swtpu_plan_streams(
            _as(lens, ctypes.c_int32), n, n_streams, drain,
            _as(emit_stream, ctypes.c_int32), _as(emit_step, ctypes.c_int64),
        )
        return emit_stream, emit_step, int(max_fill)

    def fill_streams(
        self, src: np.ndarray, lens: np.ndarray, emit_stream: np.ndarray,
        emit_step: np.ndarray, drain: int, flag_bit: int, T: int,
        n_streams: int, pad_code: int,
    ) -> np.ndarray:
        """Scatter dense reads into their planned stream slots; returns the
        [n_streams, T] int8 stream matrix (pad-prefilled, flags OR-ed)."""
        src = np.ascontiguousarray(src, np.int8)
        lens = np.ascontiguousarray(lens, np.int32)
        emit_stream = np.ascontiguousarray(emit_stream, np.int32)
        emit_step = np.ascontiguousarray(emit_step, np.int64)
        stream = np.full((n_streams, T), pad_code, np.int8)
        self._lib.swtpu_fill_streams(
            _as(src, ctypes.c_int8), _as(lens, ctypes.c_int32),
            src.shape[0], src.shape[1],
            _as(emit_stream, ctypes.c_int32), _as(emit_step, ctypes.c_int64),
            drain, flag_bit, _as(stream, ctypes.c_int8), T,
        )
        return stream

    def pack_wire(self, stream: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """One-pass stream-wire packing: (codes [N, T//4], flags [N, T//8])
        — the per-dispatch hot path of the 2.5-bit/char transfer format."""
        stream = np.ascontiguousarray(stream, np.int8)
        N, T = stream.shape
        if T % 8:
            # codes/flags widths are integer divisions — a stray T would
            # silently drop the stream tail (callers pre-pad to STEP_CHUNK,
            # but direct use must fail loudly)
            raise ValueError(f"stream length {T} must be a multiple of 8")
        codes = np.empty((N, T // 4), np.uint8)
        flags = np.empty((N, T // 8), np.uint8)
        self._lib.swtpu_pack_wire(
            _as(stream, ctypes.c_int8), N, T,
            _as(codes, ctypes.c_uint8), _as(flags, ctypes.c_uint8),
        )
        return codes, flags

    def pack_2bit(self, codes: np.ndarray) -> np.ndarray:
        codes = np.ascontiguousarray(codes, np.int8)
        out = np.zeros((len(codes) + 3) // 4, np.uint8)
        self._lib.swtpu_pack_2bit(_as(codes, ctypes.c_int8), len(codes), _as(out, ctypes.c_uint8))
        return out

    def unpack_2bit(self, packed: np.ndarray, n: int) -> np.ndarray:
        packed = np.ascontiguousarray(packed, np.uint8)
        out = np.empty(n, np.int8)
        self._lib.swtpu_unpack_2bit(_as(packed, ctypes.c_uint8), n, _as(out, ctypes.c_int8))
        return out
