"""Fast FASTA -> dense encoded database loading.

The port's copy of ``swtpu.io.loader`` (the native layer is the port's
own build of the same C++ source, ``swtpu_torch.runtime``).

The reference's host runtime parses and 2-bit-packs FASTA natively in C
(capi_sample_aligner/software-C,C++/include/aligner_Header.c:14-47,
src/main_test.c:290-314); swtpu keeps the same split — the C++ layer
(swtpu_torch/runtime) indexes and encodes the whole file in one pass, and
the database stays a dense [n, width] int8 matrix + length vector through
the rest of the pipeline (no per-read Python objects on the hot path).
Pure-Python fallback when the toolchain is unavailable.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Union

import numpy as np


@dataclasses.dataclass
class EncodedDB:
    """Dense encoded sequence set: mat[i, :lens[i]] is read i's codes."""

    names: List[str]
    mat: np.ndarray  # [n, width] int8, sentinel-padded rows
    lens: np.ndarray  # [n] int32

    def __len__(self) -> int:
        return len(self.names)

    def read(self, i: int) -> np.ndarray:
        return self.mat[i, : self.lens[i]]

    # sequence protocol: views into the dense matrix, so code written for
    # ragged read lists (oracle, resume, fingerprints) accepts an EncodedDB
    def __getitem__(self, i: int) -> np.ndarray:
        return self.read(i)

    def __iter__(self):
        return (self.read(i) for i in range(len(self.names)))

    def as_list(self) -> List[np.ndarray]:
        return [self.read(i) for i in range(len(self.names))]


def load_encoded(
    path: Union[str, Path], strict: bool = True, pad_code: int = 4
) -> EncodedDB:
    """Load and encode a whole FASTA file into an EncodedDB.

    Uses the native C++ indexer/encoder when available (one pass over the
    raw bytes), else the Python parser."""
    text = Path(path).read_bytes()
    try:
        from swtpu_torch.runtime.native import NativePacker, native_available

        if not native_available():
            raise RuntimeError("native unavailable")
        packer = NativePacker(strict=strict)
        names, rec_start, rec_end, seq_lens = packer.index_fasta(text)
        width = int(seq_lens.max()) if len(seq_lens) else 0
        mat, lens = packer.encode(text, rec_start, rec_end, max(1, width), pad_code)
        return EncodedDB(names, mat, lens)
    except RuntimeError:
        from swtpu_torch.io.encode import encode_batch
        from swtpu_torch.io.fasta import read_fasta

        recs = read_fasta(path)
        mat, lens = encode_batch([r.seq for r in recs], strict=strict)
        # encode_batch pads with 0; restore the sentinel contract
        width = mat.shape[1]
        if width:
            mask = np.arange(width)[None, :] >= lens[:, None]
            mat = np.where(mask, np.int8(pad_code), mat)
        return EncodedDB([r.name for r in recs], mat, lens)
