"""Long gaps across the chained column path's tile boundaries: the plain
B5 tile, chained by ``_chained_call`` over K = 2 and 3 tiles, against
swtpu's interpret-mode ``sw_scores_pallas`` and the oracles, at tolerance
0 (all integers).  Each cut spans a boundary between tiles, so the in-del
chain reaches the tile below through the I strip (the CUDA tile's seed) and
runs many lanes past it (its lazy carry).  A file of its own: swtpu's
interpret mode takes about a minute a call at these widths."""

import functools

import numpy as np
import pytest
import torch

from swtpu.config import DEFAULT_PENALTIES
from swtpu.ops.pallas_kernel import sw_scores_pallas
from swtpu.oracle import sw_score_batch, sw_score_single_biased
from swtpu_torch.ops import column, common
from swtpu_torch.testing.gaps import long_gap_pairs

torch.set_num_threads(1)

# (swtpu's state_dtype, score width or None)
MODES = [("int32", None), ("int16_biased", 12), ("float32", None)]
CUT = (8, 300)  # bases cut out of each target
B = 4  # pair 0 a query against itself, pairs 1-3 cut across a boundary


@functools.lru_cache(maxsize=None)
def _pairs(m):
    """The pairs at query width m and their exact oracle scores (int32's
    and float32's both: the same integers)."""
    q, t = long_gap_pairs(np.random.default_rng(50 + m), B, m, cut=CUT,
                          across=column.QUERY_TILE)
    t_lens = (t != common.T_PAD).sum(1)
    return q, t, t_lens, sw_score_batch(q, t, np.full(B, m), t_lens)


@pytest.mark.parametrize("state_dtype,width", MODES)
@pytest.mark.parametrize("m", [512, 768])
def test_long_gap_chains_equal_swtpu_and_oracle(m, state_dtype, width):
    q, t, t_lens, exact = _pairs(m)
    assert (t_lens[1:] <= m - CUT[0]).all() and t_lens[0] == m
    qp, tp = column.pad_column_batch(torch.from_numpy(q), torch.from_numpy(t),
                                     column.CPU_CHUNK)
    wide, dtype = column._resolve_state(state_dtype, width)
    tiles = []

    def tile(*args):
        tiles.append(args)
        return column.column_chained_reference(*args)

    got = column._chained_call(qp, tp, DEFAULT_PENALTIES, wide, tile=tile,
                               state_dtype=dtype).numpy()
    assert len(tiles) == m // column.QUERY_TILE
    kw = dict(state_dtype=state_dtype) if width is None else dict(
        state_dtype=state_dtype, score_width=width)
    want = (np.array([sw_score_single_biased(q[i], t[i, : t_lens[i]], DEFAULT_PENALTIES,
                                             width) for i in range(B)], np.int32)
            if width else exact)
    np.testing.assert_array_equal(got, want)
    swtpu = sw_scores_pallas(q, t, DEFAULT_PENALTIES, block_pairs=128, interpret=True,
                             unroll=1, **kw)
    np.testing.assert_array_equal(got, np.asarray(swtpu))
    if width is None:  # the self-pair: 5 a base (past a 12-bit register's ceiling)
        assert got[0] == 5 * m
