"""Length bucketing: the dispatch policy of the bucketed column path.

The port of ``swtpu.bank.buckets`` (which cannot be imported without JAX:
``swtpu/bank/__init__.py`` imports the whole ScoreBank).  Reads are grouped
into a small set of length buckets and padded up with sentinels, so every
batch is one dense [B, bucket] shape; GCUPS accounting keeps real cells
(sum of len_q*len_t) apart from padded ones.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Assignment of reads to static length buckets.

    Attributes:
      bucket_lens: ascending static lengths.
      assignments: per-read bucket index.
      fill: per-bucket ratio of real cells to padded capacity.
    """

    bucket_lens: Sequence[int]
    assignments: np.ndarray
    fill: Dict[int, float]


def plan_buckets(
    lengths: Sequence[int],
    bucket_lens: Sequence[int] = (32, 128, 512, 2048),
) -> BucketPlan:
    """Assign each read to the smallest bucket that fits it.

    Reads longer than the largest bucket raise — the analog of the
    reference's hard TARGET_LENGTH capacity; callers configure buckets for
    their data.
    """
    lens = np.asarray(lengths, dtype=np.int64)
    buckets = sorted(int(b) for b in bucket_lens)
    edges = np.array(buckets, dtype=np.int64)
    idx = np.searchsorted(edges, lens, side="left")
    if np.any(idx >= len(buckets)):
        too_long = int(lens[idx >= len(buckets)].max())
        raise ValueError(
            f"read length {too_long} exceeds largest bucket {buckets[-1]}"
        )
    fill: Dict[int, float] = {}
    for b in range(len(buckets)):
        sel = lens[idx == b]
        if len(sel):
            fill[b] = float(sel.sum()) / float(len(sel) * buckets[b])
    return BucketPlan(tuple(buckets), idx.astype(np.int32), fill)
