"""Parsers for the reference repository's golden score files.

The port's copy of ``swtpu.testing.goldens``, apart from where it looks
for the data: only where ``SWTPU_REFERENCE_DATA`` points.  Three
independent oracles agree in the reference, and each has its own file
format:

1. the RTL simulation's outputs, `data/<db>.fa_<query>.fa_out.txt`: lines
   like ``@   566ns:       >db1 score:         133`` written by the
   ScoreBank testbench (and by this package's CLI);
2. swalign dumps, `data/sw_testing.txt` (``Score: 133`` blocks per read);
3. ssearch36 `-R` score tables, `data/score.txt` and `data/score500.txt`
   (name, length, ..., the score in column 6).
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Dict

# the reference repository's data, where SWTPU_REFERENCE_DATA names its
# directory; without it there is none
_DATA = os.environ.get("SWTPU_REFERENCE_DATA")
REFERENCE_DATA_DIR = Path(_DATA) if _DATA else None

_RTL_LINE = re.compile(r"@\s*\d+\s*ns:\s*>(\S+)\s+score:\s*(-?\d+)")


def reference_data_available() -> bool:
    return REFERENCE_DATA_DIR is not None and REFERENCE_DATA_DIR.is_dir()


def parse_rtl_out_file(path: Path) -> Dict[str, int]:
    """Parse an RTL `*_out.txt` golden into {read_name: score}.

    Some goldens are partial simulation runs (data40: 16 of 40 lines), so
    callers compare by read name, not by count."""
    scores: Dict[str, int] = {}
    with open(path) as f:
        for line in f:
            m = _RTL_LINE.search(line)
            if m:
                scores[m.group(1)] = int(m.group(2))
    return scores


def parse_ssearch_scores(path: Path) -> Dict[str, int]:
    """Parse an ssearch36 -R score table into {read_name: score}."""
    scores: Dict[str, int] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or line.startswith(">>>"):
                continue
            parts = line.split()
            if len(parts) < 6:
                continue
            try:
                scores[parts[0]] = int(parts[5])
            except ValueError:
                continue
    return scores


def parse_swalign_dump(path: Path) -> Dict[str, int]:
    """Parse a sw-testing.py dump (`=== dbK: ===` blocks with `Score: S`)."""
    scores: Dict[str, int] = {}
    name = None
    with open(path) as f:
        for line in f:
            m = re.search(r"=+\s*(\S+?):\s*=+", line)
            if m:
                name = m.group(1)
                continue
            m = re.match(r"Score:\s*(-?\d+)", line.strip())
            if m and name is not None:
                scores[name] = int(m.group(1))
                name = None
    return scores
