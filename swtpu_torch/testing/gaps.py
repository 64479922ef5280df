"""Pairs whose in-del chain runs far down the query.

The column kernels put the query on the rows and the target on the
columns, so a gap in the target is a run of query rows aligned to no
column: the in-del matrix I carries it down one column, row by row.  On
random reads that chain dies within a few rows; here each target is its
query with a block of bases cut out, so I runs as far as the score before
the cut pays for it, across many of the CUDA kernel's lanes (8 rows each).
The tests and ``chip_smoke.py`` hold the column kernel against its plain
version on these pairs, since a carry that crosses one lane at a time is
never driven past one lane by random reads.
"""

from __future__ import annotations

import numpy as np

from swtpu_torch.ops.common import T_PAD

CUT = (8, 200)  # bases cut out of a target, at most m - 8
SELF_EVERY = 8  # every 8th pair (from pair 0) is a query against itself


def long_gap_pairs(rng, B, m, cut=CUT, self_every=SELF_EVERY, across=None):
    """[B, m] int8 queries and [B, m] int8 targets (numpy, sentinel-padded)
    from `rng`: query i is m random bases; target i is query i with a
    block of k bases removed, k uniform in `cut` (at most m - 8), at a
    uniform offset, then padded with T_PAD; every `self_every`-th pair is
    query i itself.  With `across` (a chained tile's rows), each cut
    instead spans a boundary between tiles, one drawn uniformly among
    those it can span: it starts above a multiple of `across` and ends
    below it, so its in-del chain reaches the tile below through the
    strips."""
    q = rng.integers(0, 4, size=(B, m), dtype=np.int8)
    t = np.full((B, m), T_PAD, np.int8)
    hi = min(cut[1], m - 8)
    ks = rng.integers(cut[0], hi + 1, size=B)
    if across is None:
        starts = rng.integers(0, m - ks + 1)
    else:
        # boundary r * across, r in 1 .. m // across - 1; the cut's first
        # row s in [max(edge - k + 1, 0), min(edge - 1, m - k)]
        edges = across * rng.integers(1, m // across, size=B)
        lo = np.maximum(edges - ks + 1, 0)
        starts = rng.integers(lo, np.minimum(edges - 1, m - ks) + 1)
    for i in range(B):
        if i % self_every == 0:
            t[i] = q[i]
            continue
        k, s = ks[i], starts[i]
        t[i, : m - k] = np.concatenate([q[i, :s], q[i, s + k:]])
    return q, t
