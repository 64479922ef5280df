"""DNA 2-bit encoding: the port's copy of ``swtpu.io.encode``.

Alphabet codes follow the reference convention T=00, C=01, A=10, G=11
(ScoreBank/ScoreBank_v1_tb.sv:44-52; ScoreBank/ScoringModule_v1.1.v
alphabet parameters).  Only *equality* of codes matters to scoring, so the
assignment is otherwise arbitrary — but keeping the reference's values means
packed buffers are byte-comparable with reference-encoded data.

Unknown-base quirk: the reference host encoder maps any unknown character
(e.g. 'N') to 0b00 with a comment claiming it is 'A', but 0b00 is T's code
(capi_sample_aligner/software-C,C++/include/aligner_Header.c:34-39).  swtpu
reproduces the *behavior* (unknown → 0) under `strict=True` (default) and
offers `strict=False` to map unknowns to a dedicated sentinel code 4 that
can never match anything (so 'N' never scores as a match even against 'T').

On-device, sequences are kept one base per int8 element — dense, VPU-friendly
and directly comparable; the 4-bases-per-byte packing used for host<->device
transfer economy is provided by pack_2bit/unpack_2bit (the analog of the
cacheline packing in aligner_Header.c:14-47).
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np

BASE_CODES = {"T": 0, "C": 1, "A": 2, "G": 3}
CODE_BASES = {v: k for k, v in BASE_CODES.items()}
SENTINEL = 4  # never-match code for unknown bases in non-strict mode

_LUT_STRICT = np.zeros(256, dtype=np.int8)  # unknown -> 0 (reference quirk)
_LUT_SENTINEL = np.full(256, SENTINEL, dtype=np.int8)
for _b, _c in BASE_CODES.items():
    _LUT_STRICT[ord(_b)] = _c
    _LUT_STRICT[ord(_b.lower())] = _c
    _LUT_SENTINEL[ord(_b)] = _c
    _LUT_SENTINEL[ord(_b.lower())] = _c


def encode_seq(seq: str, strict: bool = True) -> np.ndarray:
    """ASCII DNA string -> int8 code array (one base per element)."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    lut = _LUT_STRICT if strict else _LUT_SENTINEL
    return lut[raw]


def decode_seq(codes: Sequence[int]) -> str:
    return "".join(CODE_BASES.get(int(c), "N") for c in codes)


def encode_batch(
    seqs: Iterable[str], pad_to: int | None = None, strict: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """Encode ragged sequences into a dense [B, L] int8 array + [B] lengths.

    Pads with 0; padded tails are excluded from scoring via length masks
    (the packer's masking contract, see swtpu.bank)."""
    encoded: List[np.ndarray] = [encode_seq(s, strict=strict) for s in seqs]
    B = len(encoded)
    L = pad_to if pad_to is not None else max((len(e) for e in encoded), default=0)
    out = np.zeros((B, L), dtype=np.int8)
    lens = np.zeros((B,), dtype=np.int32)
    for i, e in enumerate(encoded):
        if len(e) > L:
            raise ValueError(f"sequence {i} length {len(e)} exceeds pad_to={L}")
        out[i, : len(e)] = e
        lens[i] = len(e)
    return out, lens


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack base codes 4-per-byte, LSB-first — the reference's transfer
    packing (aligner_Header.c:30-41 packs data[i/4] |= code << 2*(i%4)).
    Codes must be < 4 (sentinel code cannot be packed)."""
    codes = np.asarray(codes, dtype=np.uint8)
    if codes.ndim != 1:
        raise ValueError("pack_2bit expects a 1-D code array")
    if np.any(codes > 3):
        raise ValueError("codes >= 4 cannot be 2-bit packed")
    n = len(codes)
    padded = np.zeros(((n + 3) // 4) * 4, dtype=np.uint8)
    padded[:n] = codes
    quads = padded.reshape(-1, 4)
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    return (quads << shifts).astype(np.uint8).sum(axis=1).astype(np.uint8)


def unpack_2bit(packed: np.ndarray, n_bases: int) -> np.ndarray:
    packed = np.asarray(packed, dtype=np.uint8)
    quads = (packed[:, None] >> np.array([0, 2, 4, 6], dtype=np.uint8)) & 3
    return quads.reshape(-1)[:n_bases].astype(np.int8)
