"""Batch assembly for the bucketed column path: ragged reads -> dense
sentinel-padded [B, L] int8 batches with ID maps.

The port of ``swtpu.bank.packer`` (which imports ``swtpu.ops.common`` and
so JAX); the batches are bit-identical to swtpu's.  Each batch carries the
original read indices, so results scatter back to submission order after
scoring; rows added by ``batch_align`` carry id -1.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from swtpu_torch.bank.buckets import plan_buckets
from swtpu_torch.ops.common import Q_PAD, T_PAD


@dataclasses.dataclass
class PackedBatch:
    """One dense, scoreable batch (one bucket shape).

    Attributes:
      q: [B, m] int8, sentinel-padded query codes.
      t: [B, n] int8, sentinel-padded target codes.
      q_lens / t_lens: true lengths (for GCUPS accounting only — kernels
        never see them).
      ids: [B] original read indices (-1 for alignment rows).
    """

    q: np.ndarray
    t: np.ndarray
    q_lens: np.ndarray
    t_lens: np.ndarray
    ids: np.ndarray

    @property
    def cells(self) -> int:
        """Real DP cells: sum(q_lens * t_lens)."""
        return int(np.sum(self.q_lens.astype(np.int64) * self.t_lens.astype(np.int64)))

    @property
    def padded_cells(self) -> int:
        return int(self.q.shape[0]) * int(self.q.shape[1]) * int(self.t.shape[1])


def _pack_dense(seqs: List[np.ndarray], width: int, pad_code: int) -> Tuple[np.ndarray, np.ndarray]:
    B = len(seqs)
    out = np.full((B, width), pad_code, dtype=np.int8)
    lens = np.zeros((B,), dtype=np.int32)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
        lens[i] = len(s)
    return out, lens


def pack_pairs(
    queries: Sequence[np.ndarray],
    targets: Sequence[np.ndarray],
    q_width: int,
    t_width: int,
    ids: Optional[np.ndarray] = None,
) -> PackedBatch:
    """Pack explicit (query, target) pairs into one dense batch."""
    if len(queries) != len(targets):
        raise ValueError("queries and targets must pair up")
    q, q_lens = _pack_dense(list(queries), q_width, Q_PAD)
    t, t_lens = _pack_dense(list(targets), t_width, T_PAD)
    if ids is None:
        ids = np.arange(len(queries), dtype=np.int32)
    return PackedBatch(q, t, q_lens, t_lens, np.asarray(ids, dtype=np.int32))


def pack_many_vs_one(
    query: np.ndarray,
    targets: Sequence[np.ndarray],
    bucket_lens: Sequence[int] = (32, 128, 512, 2048),
    q_width: Optional[int] = None,
    batch_align: int = 1,
    lens: Optional[np.ndarray] = None,
) -> List[PackedBatch]:
    """Pack a database of ragged reads against one query, bucketed by length.

    Returns one PackedBatch per non-empty bucket, each with `ids` mapping
    rows back to database read order.

    targets: a sequence of 1-D code arrays, or — the dense form — a
    [n, width] int8 sentinel-padded matrix with `lens` (rows scatter into
    buckets with one vectorized gather each, no per-read Python).

    batch_align pads each bucket's batch up to a multiple with sentinel
    rows; padded rows carry id -1.
    """
    dense = lens is not None
    if dense:
        tmat = np.asarray(targets)
        lens_arr = np.asarray(lens, np.int32)
        n_reads = tmat.shape[0]
    else:
        lens_arr = np.array([len(t) for t in targets], np.int32)
        n_reads = len(lens_arr)
    if n_reads == 0:
        return []
    plan = plan_buckets(list(lens_arr), bucket_lens)
    qw = q_width or max(8, -(-len(query) // 8) * 8)
    if len(query) > qw:
        raise ValueError(f"query length {len(query)} exceeds q_width {qw}")
    out: List[PackedBatch] = []
    for b, width in enumerate(plan.bucket_lens):
        rows = np.nonzero(plan.assignments == b)[0]
        if len(rows) == 0:
            continue
        B = len(rows)
        Bp = -(-B // batch_align) * batch_align
        t = np.full((Bp, width), T_PAD, dtype=np.int8)
        t_lens = np.zeros((Bp,), dtype=np.int32)
        ids = np.full((Bp,), -1, dtype=np.int32)
        if dense:
            # row tails past each read's length are already T_PAD by the
            # EncodedDB contract, so a plain gather preserves the sentinels
            w = min(width, tmat.shape[1])
            t[:B, :w] = tmat[rows, :w]
            t_lens[:B] = lens_arr[rows]
            ids[:B] = rows.astype(np.int32)
        else:
            for k, r in enumerate(rows):
                seq = targets[r]
                t[k, : len(seq)] = seq
                t_lens[k] = len(seq)
                ids[k] = r
        q = np.full((Bp, qw), Q_PAD, dtype=np.int8)
        q[:, : len(query)] = np.asarray(query, dtype=np.int8)[None, :]
        q_lens = np.full((Bp,), len(query), dtype=np.int32)
        q_lens[B:] = 0
        out.append(PackedBatch(q, t, q_lens, t_lens, ids))
    return out
