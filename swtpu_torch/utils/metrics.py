"""Observability: the per-batch event log.

The port's copy of ``swtpu.utils.metrics``' ``BatchEvent`` and
``EventLog``: structured JSONL event records (the reference's PSLSE
debug.log and its parser, human-readable from the start), written line for
line as swtpu writes them.  GCUPS counts *real* cells (sum len_q*len_t),
never padded capacity, so bucketing efficiency is visible rather than
flattering.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import IO, List, Optional, Union


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
