"""FASTA reading/writing: the port's copy of ``swtpu.io.fasta``.

The reference consumes FASTA in three places with identical expectations
(data/sw-testing.py:13-27, ScoreBank testbench file readers, and the host
app's read_sequences in capi_sample_aligner/software-C,C++/src/main_test.c):
a `>query` record followed by `>dbK` records, one sequence line per record.
This module is a general multi-line FASTA parser that also reproduces the
query/database split convention.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Tuple, Union


@dataclasses.dataclass
class FastaRecord:
    name: str
    seq: str


def read_fasta(path: Union[str, Path]) -> List[FastaRecord]:
    """Parse a FASTA file into records (multi-line sequences supported)."""
    records: List[FastaRecord] = []
    name = None
    chunks: List[str] = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    records.append(FastaRecord(name, "".join(chunks)))
                name = line[1:].split()[0]
                chunks = []
            else:
                if name is None:
                    raise ValueError(f"{path}: sequence data before any header")
                chunks.append(line.upper())
    if name is not None:
        records.append(FastaRecord(name, "".join(chunks)))
    return records


def read_query_and_db(
    path: Union[str, Path]
) -> Tuple[List[FastaRecord], List[FastaRecord]]:
    """Split records into (queries, database reads) by the reference's
    naming convention: records named `query*` are queries, everything else
    is a database read (data/generate.py:16-19 labels the first read
    `>query` and the rest `>dbK`)."""
    records = read_fasta(path)
    queries = [r for r in records if r.name.startswith("query")]
    db = [r for r in records if not r.name.startswith("query")]
    return queries, db


def write_fasta(path: Union[str, Path], records: List[FastaRecord]) -> None:
    with open(path, "w") as f:
        for r in records:
            f.write(f">{r.name}\n{r.seq}\n")
