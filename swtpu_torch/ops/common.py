"""The sentinel-padding contract shared by the port's kernels.

Real base codes are 0..3.  Query pads take ``Q_PAD`` and target pads take
``T_PAD``; the two never compare equal, so a padded cell always takes the
mismatch penalty and can never raise a score (see ``swtpu.ops.common``,
whose values and helpers these are).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

Q_PAD = 5
T_PAD = 4


def pad_to_static(
    seqs: np.ndarray,
    lens: np.ndarray,
    pad_code: int,
    pad_len: int | None = None,
) -> np.ndarray:
    """Replace tail padding of a dense [B, L] code array with `pad_code`
    and optionally extend to a static length (bucket width)."""
    seqs = np.asarray(seqs)
    B, L = seqs.shape
    out_len = pad_len if pad_len is not None else L
    if out_len < L:
        if np.any(lens > out_len):
            raise ValueError(f"pad_len={out_len} < max sequence length")
        seqs = seqs[:, :out_len]
        L = out_len
    out = np.full((B, out_len), pad_code, dtype=seqs.dtype)
    out[:, :L] = np.where(
        np.arange(L)[None, :] < np.asarray(lens)[:, None], seqs, pad_code
    )
    return out


def sentinel_pad_batch(
    q: np.ndarray,
    q_lens: np.ndarray,
    t: np.ndarray,
    t_lens: np.ndarray,
    q_pad_len: int | None = None,
    t_pad_len: int | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Apply the sentinel-padding contract to a (query, target) batch."""
    return (
        pad_to_static(q, q_lens, Q_PAD, q_pad_len),
        pad_to_static(t, t_lens, T_PAD, t_pad_len),
    )
