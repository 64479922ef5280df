"""swtpu_torch — the PyTorch/CUDA port of swtpu's Smith-Waterman scorer.

Batched, score-only Smith-Waterman local alignment with affine gaps, as in
``swtpu``, on a torch device: the streamed-wavefront path
(``ScoreBank.score_database`` for queries of any length, longer than 128
bases on chained tiles, in chunks with ``SWConfig.stream_chunk_reads``, and
``score_pairs`` on pair streams), and the bucketed column path
(``backend="pallas"``, or a callable backend in the column kernels' place:
``score_database`` and ``score_pairs``), both exact or with
``SWConfig.score_width`` and the wavefront in every state type of swtpu's,
with hand-written CUDA kernels on the GPU and their plain PyTorch versions
on the CPU; resident serving (``load_database`` once, then
``score_loaded``, ``score_loaded_many`` and ``topk_loaded`` a query) and
the serving daemon; resumable jobs, seeded fault injection and the CLI;
the scan backend; scoring across devices (a mesh of shards, sharded
scorers with the merged top-K, mesh-resident serving) and processes
(``torch.distributed``, the localhost worker harness); the
config-driven regression suites (``regress``); swtpu's benchmarks
(``bench``: the headline GCUPS line; ``bench_scaling``); and the kernel
shootout's lane-major column kernel and the two microbenchmarks' kernels.
Imports torch and never JAX, and nothing of ``swtpu``: the
configuration, the oracle, FASTA loading, the native packer, the event log
and the golden parsers are the port's own copies of swtpu's JAX-free
modules.

Layer map (swtpu module -> port):

  swtpu.config           -> swtpu_torch.config         (Penalties, SWConfig; a copy)
  swtpu.oracle           -> swtpu_torch.oracle         (the exact oracle; a copy)
  swtpu.io               -> swtpu_torch.io             (FASTA, encoders, EncodedDB; a copy)
  swtpu.runtime.native   -> swtpu_torch.runtime        (the C++ packer, built by g++)
  swtpu.utils.metrics    -> swtpu_torch.utils.metrics  (BatchEvent, EventLog, GcupsMeter:
                                                        copies; profile_trace on
                                                        torch.profiler)
  swtpu.bank.scorebank   -> swtpu_torch.bank.scorebank (stream, chunked, resident and
                                                        pallas paths; callable backends)
  swtpu.bank.streams     -> swtpu_torch.bank.streams   (stream host packer, score_streams)
  swtpu.bank.buckets     -> swtpu_torch.bank.buckets   (length buckets)
  swtpu.bank.packer      -> swtpu_torch.bank.packer    (bucket host packer)
  swtpu.bank.resume      -> swtpu_torch.bank.resume    (resumable jobs; swtpu's state file)
  swtpu.ops.pallas_stream-> swtpu_torch.ops.stream     (+ csrc/stream_wavefront.cu)
  swtpu.ops.pallas_kernel-> swtpu_torch.ops.column     (+ csrc/column.cu)
  swtpu.ops.pallas_lane  -> swtpu_torch.ops.lane       (+ csrc/lane.cu)
  experiments/microbench_ops.py, kernel_ablate.py
                         -> swtpu_torch.ops.microbench (+ csrc/microbench.cu)
  swtpu.ops.common       -> swtpu_torch.ops.common     (sentinel padding)
  swtpu.ops.scan         -> swtpu_torch.ops.scan       (the column scan, torch ops)
  swtpu.parallel.mesh    -> swtpu_torch.parallel.mesh  (Mesh: devices, rank, world)
  swtpu.parallel.sharded -> swtpu_torch.parallel.sharded, .topk
                                                       (sharded scorers, the merged
                                                        top-K, the device top-k cut)
  swtpu.parallel.multihost
                         -> swtpu_torch.parallel.multihost (torch.distributed)
  swtpu.bank.serving     -> swtpu_torch.bank.serving   (mesh-resident serving)
  swtpu.utils.guards     -> swtpu_torch.utils.guards   (stream and batch checks,
                                                        checksum)
  swtpu.testing.faults   -> swtpu_torch.testing.faults (seeded fault injection)
  swtpu.testing.worker, regress (its multi-process half)
                         -> swtpu_torch.testing.worker, .regress
                                                       (the localhost harness)
  swtpu.testing.suite    -> swtpu_torch.testing.suite  (config-driven regression
                                                        suites: run_suite, main_cli)
  swtpu.testing.goldens  -> swtpu_torch.testing.goldens (golden-file parsers; a copy)
  swtpu.server           -> swtpu_torch.server         (ServeEngine, serve_socket,
                                                        format_score_line)
  bench.py (root)        -> swtpu_torch.bench          (the headline GCUPS stages and
                                                        swtpu's one JSON line)
  bench_scaling.py (root)-> swtpu_torch.bench_scaling  (reads/s over mesh sizes and
                                                        localhost processes)
  swtpu.cli              -> swtpu_torch.cli            (score, serve [--sharded],
                                                        oracle, generate, diff, events,
                                                        regress, bench)
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
