"""The port's lane-major column kernel's plain version (B6) against swtpu's
interpret-mode Pallas kernel, the column path and the oracle.  All
integers: bit-equal.  The CUDA kernel's own tests are in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from swtpu.config import Penalties as RefPenalties
from swtpu.ops.pallas_lane import sw_scores_pallas_lane
from swtpu.oracle import sw_score_batch
from swtpu_torch.config import DEFAULT_PENALTIES, Penalties
from swtpu_torch.ops import lane
from swtpu_torch.ops.column import sw_scores_column
from swtpu_torch.ops.common import Q_PAD, T_PAD

torch.set_num_threads(1)

CUSTOM = (2, -3, -4, -1)  # match, mismatch, open, extend


def _batch(seed, B, m, n):
    """Sentinel-padded ragged pairs (lengths 1..m, 1..n); pair 0 matches
    itself over min(m, n) bases."""
    rng = np.random.default_rng(seed)
    q_lens = rng.integers(1, m + 1, size=B)
    t_lens = rng.integers(1, n + 1, size=B)
    q = rng.integers(0, 4, size=(B, m)).astype(np.int8)
    t = rng.integers(0, 4, size=(B, n)).astype(np.int8)
    k = min(m, n)
    t[0, :k] = q[0, :k]
    q_lens[0] = t_lens[0] = k
    q[np.arange(m)[None, :] >= q_lens[:, None]] = Q_PAD
    t[np.arange(n)[None, :] >= t_lens[:, None]] = T_PAD
    return q, q_lens, t, t_lens


def _port(q, t, pen):
    got = lane.sw_scores_lane(torch.from_numpy(q), torch.from_numpy(t), pen)
    assert got.dtype == torch.int32 and got.shape == (len(q),)
    return got.numpy()


@pytest.mark.parametrize(
    "B,m,n,pen",
    [
        (1, 1, 1, None),
        (1, 128, 150, CUSTOM),
        (20, 40, 150, None),
        (20, 128, 1, CUSTOM),
    ],
)
def test_lane_equals_swtpu_interpret_and_oracle(B, m, n, pen):
    q, q_lens, t, t_lens = _batch(B * 3 + m + n, B, m, n)
    port_pen = Penalties(*pen) if pen else DEFAULT_PENALTIES
    ref_pen = RefPenalties(*pen) if pen else RefPenalties()
    want = np.asarray(sw_scores_pallas_lane(q, t, ref_pen, interpret=True))
    got = _port(q, t, port_pen)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, sw_score_batch(q, t, q_lens, t_lens, ref_pen))


@pytest.mark.parametrize("m", [1, 40, 128])
@pytest.mark.parametrize("n", [1, 150])
@pytest.mark.parametrize("pen", [None, CUSTOM])
def test_lane_equals_column_path_and_oracle(m, n, pen):
    q, q_lens, t, t_lens = _batch(m * 7 + n, 20, m, n)
    port_pen = Penalties(*pen) if pen else DEFAULT_PENALTIES
    got = _port(q, t, port_pen)
    col = sw_scores_column(torch.from_numpy(q), torch.from_numpy(t), port_pen)
    np.testing.assert_array_equal(got, col.numpy())
    np.testing.assert_array_equal(got, sw_score_batch(q, t, q_lens, t_lens, port_pen))
    assert got[0] == port_pen.match * min(m, n)


def test_lane_padding_follows_swtpu():
    """Pairs to a multiple of min(512, max(8, B)), the query to 128 int32
    rows of Q_PAD, the target to a multiple of 128 columns of T_PAD."""
    q = torch.zeros((11, 40), dtype=torch.int8)
    t = torch.ones((11, 130), dtype=torch.int8)
    qp, tp = lane.pad_lane_batch(q, t)
    assert (qp.dtype, tuple(qp.shape)) == (torch.int32, (11, 128))
    assert (tp.dtype, tuple(tp.shape)) == (torch.int8, (11, 256))
    assert (qp[:, 40:] == Q_PAD).all() and (tp[:, 130:] == T_PAD).all()
    qp, tp = lane.pad_lane_batch(q[:5], t[:5])
    assert qp.shape[0] == tp.shape[0] == 8
    assert (qp[5:] == Q_PAD).all() and (tp[5:] == T_PAD).all()
    qp, _ = lane.pad_lane_batch(torch.zeros((600, 8), dtype=torch.int8),
                                torch.zeros((600, 8), dtype=torch.int8))
    assert qp.shape[0] == 1024


def test_query_over_128_raises_like_swtpu():
    q = np.zeros((2, 129), np.int8)
    t = np.zeros((2, 10), np.int8)
    with pytest.raises(ValueError) as e_ref:
        sw_scores_pallas_lane(q, t, interpret=True)
    with pytest.raises(ValueError) as e:
        lane.sw_scores_lane(torch.from_numpy(q), torch.from_numpy(t))
    assert str(e.value) == str(e_ref.value) == "lane kernel requires m <= 128, got 129"


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached lane_scores_cuda")

    cuda = lane.lane_scores_cuda
    launches = cuda.launches
    q = torch.full((4, 128), Q_PAD, dtype=torch.int32)
    t = torch.full((4, 128), T_PAD, dtype=torch.int8)
    with pytest.raises(ValueError, match="q must be a CUDA int32 tensor"):
        cuda(q, t)
    monkeypatch.setattr(lane, "lane_scores_cuda", refuse)
    assert (lane.sw_scores_lane(q[:, :8].to(torch.int8), t) == 0).all()
    with pytest.raises(ValueError, match="no lane kernel for device meta"):
        lane._lane_call(q.to("meta"), t.to("meta"), DEFAULT_PENALTIES)
    assert cuda.launches == launches
