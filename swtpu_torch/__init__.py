"""swtpu_torch — the PyTorch/CUDA port of swtpu's Smith-Waterman scorer.

Batched, score-only Smith-Waterman local alignment with affine gaps, as in
``swtpu``, on a torch device: the streamed-wavefront path
(``ScoreBank.score_database`` for queries of any length, longer than 128
bases on chained tiles, and ``score_pairs`` on pair streams), and the
bucketed column path (``backend="pallas"``: ``score_database`` and
``score_pairs``), both exact or with ``SWConfig.score_width`` (the
wavefront also with float32 state), with hand-written CUDA
kernels on the GPU and their plain PyTorch versions on the CPU; and the
kernel shootout's lane-major column kernel and the two microbenchmarks'
kernels.  Imports torch and never JAX, and nothing of ``swtpu``: the
configuration, the oracle, FASTA loading, the native packer and the event
log are the port's own copies of swtpu's JAX-free modules.

Layer map (swtpu module -> port):

  swtpu.config           -> swtpu_torch.config         (Penalties, SWConfig; a copy)
  swtpu.oracle           -> swtpu_torch.oracle         (the exact oracle; a copy)
  swtpu.io               -> swtpu_torch.io             (FASTA, encoders, EncodedDB; a copy)
  swtpu.runtime.native   -> swtpu_torch.runtime        (the C++ packer, built by g++)
  swtpu.utils.metrics    -> swtpu_torch.utils.metrics  (BatchEvent, EventLog; a copy)
  swtpu.bank.scorebank   -> swtpu_torch.bank.scorebank (stream and pallas paths)
  swtpu.bank.streams     -> swtpu_torch.bank.streams   (stream host packer)
  swtpu.bank.buckets     -> swtpu_torch.bank.buckets   (length buckets)
  swtpu.bank.packer      -> swtpu_torch.bank.packer    (bucket host packer)
  swtpu.ops.pallas_stream-> swtpu_torch.ops.stream     (+ csrc/stream_wavefront.cu)
  swtpu.ops.pallas_kernel-> swtpu_torch.ops.column     (+ csrc/column.cu)
  swtpu.ops.pallas_lane  -> swtpu_torch.ops.lane       (+ csrc/lane.cu)
  experiments/microbench_ops.py, kernel_ablate.py
                         -> swtpu_torch.ops.microbench (+ csrc/microbench.cu)
  swtpu.ops.common       -> swtpu_torch.ops.common     (sentinel padding)
  swtpu.utils.guards     -> swtpu_torch.utils.guards   (stream and batch checks)
  swtpu.cli score        -> swtpu_torch.cli score     (+ format_score_line)
"""

from swtpu_torch.bank import ScoreBank, ScoreResult
from swtpu_torch.config import DEFAULT_PENALTIES, Penalties, SWConfig
from swtpu_torch.oracle import score_many_vs_one, sw_score_batch, sw_score_single

__version__ = "0.1.0"

__all__ = [
    "SWConfig",
    "Penalties",
    "DEFAULT_PENALTIES",
    "sw_score_single",
    "sw_score_batch",
    "score_many_vs_one",
    "ScoreBank",
    "ScoreResult",
]
