"""The top-k cut of a score vector on its device.

The port of ``swtpu.parallel.sharded._local_topk``.  swtpu cuts in two
levels of ``lax.top_k`` because a flat one lowered to a sort on the TPU;
``torch.topk`` leaves the order of equal values unspecified, so here one
``torch.topk`` runs over int64 keys that hold the score in the high 32
bits and the complement of the position in the low 32.  The keys are
unique, so no tie is left for ``topk`` to order.
"""

from __future__ import annotations

import torch


def _local_topk(masked: torch.Tensor, ids: torch.Tensor, kk: int):
    """The kk best entries of `masked` [R] int32 by score descending,
    then position ascending: (scores [kk] int32, ids [kk] int32, each
    entry's `ids` value; -1 where the caller marked a sentinel position).

    swtpu's callers give ids that ascend with the position (masking
    sentinels to -2^30), so the order is score descending, then id
    ascending, as ``ScoreResult.top_k``'s.  kk must not exceed R."""
    R = masked.shape[0]
    low = (1 << 32) - 1 - torch.arange(R, dtype=torch.int64, device=masked.device)
    key = masked.to(torch.int64) * (1 << 32) + low
    pos = torch.topk(key, kk).indices
    return masked[pos], ids[pos]
