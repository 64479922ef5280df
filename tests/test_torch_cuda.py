"""The CUDA wavefront kernel on the card: its strip against the plain
PyTorch version, and ScoreBank(device="cuda") against the oracle.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from swtpu_torch import DEFAULT_PENALTIES, SWConfig, ScoreBank, score_many_vs_one
from swtpu_torch.bank.scorebank import EncodedDB
from swtpu_torch.bank.streams import pack_streams
from swtpu_torch.ops import stream as port

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _db(rng, n, hi):
    """EncodedDB of reads of 0..hi-1 bases, reads 2 and 5 zero-length."""
    lens = rng.integers(1, hi, size=n).astype(np.int32)
    lens[[2, 5]] = 0
    mat = rng.integers(0, 4, size=(n, hi)).astype(np.int8)
    mat[np.arange(hi)[None, :] >= lens[:, None]] = 4
    return EncodedDB([f"db{i}" for i in range(n)], mat, lens)


@pytest.mark.parametrize(
    "segments,rows", [(1, 1), (1, 2), (1, 16), (2, 8), (4, 4), (8, 1), (8, 16)]
)
def test_kernel_strip_equals_plain_version(cuda_device, segments, rows):
    rng = np.random.default_rng(segments * 31 + rows)
    db = _db(rng, 400, 200)
    query = rng.integers(0, 4, size=128 // segments - 1).astype(np.int8)
    phys = 40  # not a multiple of a warp's streams: ragged last block
    b = pack_streams(query, db.mat, n_streams=phys * segments, segments=segments,
                     lens=db.lens, rows=rows)
    qk, sk = port._to_kernel_layout(
        torch.from_numpy(b.q), torch.from_numpy(b.stream), segments, rows
    )
    want = port.stream_strip_reference(qk, sk, DEFAULT_PENALTIES, segments, rows)
    launches = port.stream_strip_cuda.launches
    got = port.stream_strip_cuda(
        qk.to(cuda_device), sk.to(cuda_device), DEFAULT_PENALTIES, segments, rows
    )
    torch.cuda.synchronize()
    assert port.stream_strip_cuda.launches == launches + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_kernel_rejects_bad_tensors(cuda_device):
    qk = torch.zeros((128, 8), dtype=torch.int8, device=cuda_device)
    sk = torch.zeros((32, 8), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="CUDA int8 tensor"):
        port.stream_strip_cuda(qk.int(), sk, DEFAULT_PENALTIES, 1, 16)
    with pytest.raises(ValueError, match="contiguous"):
        port.stream_strip_cuda(qk, torch.zeros((8, 32), dtype=torch.int8,
                                               device=cuda_device).t(),
                               DEFAULT_PENALTIES, 1, 16)


@pytest.mark.parametrize("qlen", [20, 60, 128])
@pytest.mark.parametrize("wire", [True, False])
def test_score_database_equals_oracle(cuda_device, qlen, wire):
    rng = np.random.default_rng(qlen + wire)
    db = _db(rng, 3000, 200)
    query = rng.integers(0, 4, size=qlen).astype(np.int8)
    launches = port.stream_strip_cuda.launches
    res = ScoreBank(SWConfig(wire_2bit=wire), device=cuda_device).score_database(query, db)
    assert port.stream_strip_cuda.launches == launches + 1
    np.testing.assert_array_equal(res.scores, score_many_vs_one(query, db.as_list()))
