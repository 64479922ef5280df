"""Observability: the per-batch event log, a GCUPS meter and a profiler
hook.

The port of ``swtpu.utils.metrics``: ``BatchEvent`` and ``EventLog``,
structured JSONL event records (the reference's PSLSE debug.log and its
parser, human-readable from the start), written line for line as swtpu
writes them; ``GcupsMeter``, a copy of swtpu's; and ``profile_trace``,
swtpu's ``jax.profiler`` hook on ``torch.profiler``.  GCUPS counts *real*
cells (sum len_q*len_t), never padded capacity, so bucketing efficiency is
visible rather than flattering.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from pathlib import Path
from typing import IO, Iterator, List, Optional, Union


@dataclasses.dataclass
class BatchEvent:
    kind: str  # "batch" | "bucket" | "job" | ...
    t_wall: float
    elapsed_s: float
    reads: int = 0
    cells: int = 0
    padded_cells: int = 0
    note: str = ""

    @property
    def gcups(self) -> float:
        return self.cells / self.elapsed_s / 1e9 if self.elapsed_s > 0 else 0.0

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["gcups"] = round(self.gcups, 3)
        return json.dumps(d)


class EventLog:
    """Append-only JSONL event log with a parser (debug.log analog)."""

    def __init__(self, path: Optional[Union[str, Path]] = None):
        self.path = Path(path) if path else None
        self.events: List[BatchEvent] = []
        self._fh: Optional[IO] = None
        if self.path:
            self._fh = open(self.path, "a")

    def emit(self, event: BatchEvent) -> None:
        self.events.append(event)
        if self._fh:
            self._fh.write(event.to_json() + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    @staticmethod
    def parse(path: Union[str, Path]) -> List[BatchEvent]:
        out: List[BatchEvent] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                d = json.loads(line)
                d.pop("gcups", None)
                out.append(BatchEvent(**d))
        return out


class GcupsMeter:
    """Running real-cell throughput accounting."""

    def __init__(self) -> None:
        self.cells = 0
        self.padded_cells = 0
        self.reads = 0
        self.elapsed_s = 0.0

    @contextlib.contextmanager
    def batch(self, cells: int, padded_cells: int, reads: int) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.cells += cells
        self.padded_cells += padded_cells
        self.reads += reads
        self.elapsed_s += dt

    @property
    def gcups(self) -> float:
        return self.cells / self.elapsed_s / 1e9 if self.elapsed_s > 0 else 0.0

    @property
    def reads_per_s(self) -> float:
        return self.reads / self.elapsed_s if self.elapsed_s > 0 else 0.0

    @property
    def pad_efficiency(self) -> float:
        return self.cells / self.padded_cells if self.padded_cells else 0.0


@contextlib.contextmanager
def profile_trace(log_dir: Optional[Union[str, Path]], device=None) -> Iterator[None]:
    """``torch.profiler`` around a scoring region: the host's activity,
    and the card's when `device` is a CUDA device (None: whenever CUDA is
    available), written on exit as a Chrome trace (open it in Perfetto or
    chrome://tracing) into `log_dir`, which is made if missing.  Does
    nothing when `log_dir` is falsy.  On a card the device is synchronised
    before the profiler starts (its context exists and earlier work has
    ended) and before it stops, so that every kernel the region launched
    has finished before the profiler collects the card's records."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_cuda = (torch.device(device).type == "cuda" if device is not None
               else torch.cuda.is_available())
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    if on_cuda:
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if on_cuda:
                torch.cuda.synchronize(device)
    prof.export_chrome_trace(str(out / f"swtpu_torch.{os.getpid()}.{time.time_ns()}.pt.trace.json"))
