"""Config-driven regression suites on a torch device.

The port of ``swtpu.testing.suite``: a JSON suite names fault-injection
ranges, the process topology, seeded datasets and the checks to run, and
`run_suite` runs them (on the card unless the caller asks for the CPU) and
returns structured pass/fail outcomes, the same ones as swtpu's for the
same suite.  The checks: parity with the oracle, faulted scheduling, a
corrupted batch or result caught in situ on the bucketed path and on the
stream path, resume, the top-K, and the multi-process tier (a plain job,
resume cursors, a lying worker).

Run via CLI:  python -m swtpu_torch.cli [--device cuda|cpu] regress --suite suites/default.json
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Union
from unittest import mock

import numpy as np
import torch

from swtpu_torch.bank import scorebank

DEFAULT_SUITE: Dict[str, Any] = {
    "name": "default",
    "seed": 1234,
    "fail": "ERROR",  # ERROR: nonzero exit on failure; WARNING: report only
    "faults": {"reorder_percent": 100, "drop_percent": 30, "delay_ms_max": 1},
    "datasets": [
        {"reads": 40, "min_len": 5, "max_len": 200, "query_len": 31},
        {"reads": 15, "min_len": 1, "max_len": 32, "query_len": 8},
    ],
    "tests": [
        "oracle_parity",
        "faulted_scheduling",
        "corruption_inject",
        "corruption_inject_stream",
        "resume",
        "topk_merge",
        "lying_device",  # runs only when multihost is enabled
    ],
    # the multihost/adversary tier lives in suites/multihost.json (it spawns
    # 2 OS worker processes per run, 37.26-37.93 s through the CLI on an NVIDIA
    # H100 80GB HBM3 at 700.00 W: chip_smoke.py's phase "regress"); the
    # default suite stays fast
    "multihost": {"enabled": False, "nprocs": 2},
}


@dataclasses.dataclass
class TestOutcome:
    name: str
    dataset: int
    passed: bool
    detail: str = ""
    skipped: bool = False  # listed in the suite but not runnable here


def _gen_dataset(rng, spec):
    targets = [
        rng.integers(0, 4, size=rng.integers(spec["min_len"], spec["max_len"] + 1)).astype(np.int8)
        for _ in range(spec["reads"])
    ]
    query = rng.integers(0, 4, size=spec["query_len"]).astype(np.int8)
    return query, targets


@contextlib.contextmanager
def corrupted_stream_codes():
    """pack_streams, as ScoreBank calls it, writes an invalid char class
    into each packed batch, which check_stream_batch must reject."""
    real_pack = scorebank.pack_streams

    def corrupting_pack(*a, **kw):
        b = real_pack(*a, **kw)
        b.stream[0, 0] = 6  # invalid char class
        return b

    with mock.patch.object(scorebank, "pack_streams", corrupting_pack):
        yield


def _over_bound(emit_stream):
    return torch.full((len(emit_stream),), 10 ** 6, dtype=torch.int32,
                      device=emit_stream.device)


# the stream path's scoring entries, by the names that
# ScoreBank._score_database_stream looks up in its own module at call time:
# the plain form (the CPU) and the 2-bit wire form (CUDA)
STREAM_SCORE_FAKES = {
    "sw_scores_stream": lambda q, s, es, ep, *a, **kw: _over_bound(es),
    "sw_scores_stream_packed": lambda q, c, f, es, ep, *a, **kw: _over_bound(es),
}


def corrupted_stream_scores():
    """Both stream scoring entries, as ScoreBank calls them, return a score
    over the bound on the bank's device, which check_scores must reject."""
    return mock.patch.multiple(scorebank, **STREAM_SCORE_FAKES)


def run_suite(
    suite: Optional[Union[str, Path, Dict[str, Any]]] = None,
    device="cuda",
) -> List[TestOutcome]:
    """Run `suite` (a JSON path, a dict merged over DEFAULT_SUITE, or None
    for DEFAULT_SUITE) with every bank and worker on `device`."""
    from swtpu_torch.bank import ScoreBank
    from swtpu_torch.bank.resume import score_database_resumable
    from swtpu_torch.config import SWConfig
    from swtpu_torch.oracle import score_many_vs_one
    from swtpu_torch.testing.faults import FaultConfig, score_database_with_faults
    from swtpu_torch.utils.guards import IntegrityError

    if suite is None:
        cfg = dict(DEFAULT_SUITE)
    elif isinstance(suite, (str, Path)):
        cfg = {**DEFAULT_SUITE, **json.loads(Path(suite).read_text())}
    else:
        cfg = {**DEFAULT_SUITE, **suite}

    rng = np.random.default_rng(cfg["seed"])
    outcomes: List[TestOutcome] = []
    bank = ScoreBank(SWConfig(target_buckets=(32, 128, 256, 1024)), backend="scan",
                     device=device)

    for di, spec in enumerate(cfg["datasets"]):
        query, targets = _gen_dataset(rng, spec)
        want = score_many_vs_one(query, targets)

        def record(name, passed, detail=""):
            outcomes.append(TestOutcome(name, di, bool(passed), detail))

        if "oracle_parity" in cfg["tests"]:
            res = bank.score_database(query, targets)
            record("oracle_parity", np.array_equal(res.scores, want))

        if "faulted_scheduling" in cfg["tests"]:
            fc = FaultConfig(seed=cfg["seed"] + di, **cfg["faults"])
            scores, inj = score_database_with_faults(bank, query, targets, fc)
            record(
                "faulted_scheduling",
                np.array_equal(scores, want),
                f"drops={inj.injected_drops} reorders={inj.injected_reorders}",
            )

        if "corruption_inject" in cfg["tests"]:
            # corrupt a packed batch / a result and prove verify_integrity
            # rejects it in situ (without the guards the corruption would
            # pass silently)
            vbank = ScoreBank(bank.config, backend="scan", device=device,
                              verify_integrity=True)
            ok = True
            detail = []
            for kind in ("codes", "scores"):
                fc = FaultConfig(
                    seed=cfg["seed"] + di, corrupt_percent=100,
                    corrupt_kind=kind,
                )
                try:
                    score_database_with_faults(vbank, query, targets, fc)
                    ok = False
                    detail.append(f"{kind}: NOT caught")
                except IntegrityError:
                    detail.append(f"{kind}: caught")
            record("corruption_inject", ok, "; ".join(detail))

        if "corruption_inject_stream" in cfg["tests"]:
            # the same adversary on the stream path: a flipped stream byte
            # must trip check_stream_batch between pack and kernel launch,
            # and an over-bound result must trip check_scores after gather
            sbank = ScoreBank(bank.config, backend="stream", device=device,
                              verify_integrity=True)
            ok = True
            detail = []
            try:
                with corrupted_stream_codes():
                    sbank.score_database(query, targets)
                ok = False
                detail.append("stream codes: NOT caught")
            except IntegrityError:
                detail.append("stream codes: caught")
            try:
                with corrupted_stream_scores():
                    sbank.score_database(query, targets)
                ok = False
                detail.append("stream scores: NOT caught")
            except IntegrityError:
                detail.append("stream scores: caught")
            record("corruption_inject_stream", ok, "; ".join(detail))

        if "resume" in cfg["tests"]:
            import tempfile

            with tempfile.TemporaryDirectory() as td:
                state = Path(td) / "job.npz"
                r1 = score_database_resumable(bank, query, targets, state)
                r2 = score_database_resumable(bank, query, targets, state)
                record(
                    "resume",
                    np.array_equal(r1.scores, want) and np.array_equal(r2.scores, want),
                )

        if "topk_merge" in cfg["tests"]:
            res = bank.score_database(query, targets)
            top = res.top_k(5)
            ok = all(want[i] == s for s, i in top) and top[0][0] == want.max()
            record("topk_merge", ok)

    if not cfg.get("multihost", {}).get("enabled"):
        # a listed test that cannot run here says so: no name of a suite
        # is dropped from its report
        for name in ("multihost", "lying_device", "resume_cursor"):
            if name == "multihost" or name in cfg["tests"]:
                outcomes.append(
                    TestOutcome(
                        name, -1, True,
                        "multihost disabled in this suite", skipped=True,
                    )
                )
    else:
        from swtpu_torch.oracle import sw_score_batch
        from swtpu_torch.testing.regress import run_multihost

        nprocs = cfg["multihost"]["nprocs"]
        B = 8 * nprocs
        q = rng.integers(0, 4, size=(B, 16)).astype(np.int8)
        t = rng.integers(0, 4, size=(B, 24)).astype(np.int8)
        want = sw_score_batch(q, t)
        res = run_multihost(q, t, np.arange(B, dtype=np.int32), nprocs=nprocs, device=device)
        outcomes.append(
            TestOutcome("multihost", -1, bool(np.array_equal(res.scores, want)))
        )
        if "resume_cursor" in cfg["tests"]:
            # cursor recovery from the suite runner: a finished shard
            # resumes from disk, and the merged result is exact
            import tempfile

            from swtpu_torch.ops.common import T_PAD

            B2, n2 = 8, 24
            lens2 = rng.integers(4, n2 + 1, size=B2).astype(np.int32)
            t2 = np.full((B2, n2), T_PAD, np.int8)
            for i in range(B2):
                t2[i, : lens2[i]] = rng.integers(0, 4, size=lens2[i]).astype(np.int8)
            q2 = rng.integers(0, 4, size=12).astype(np.int8)
            want2 = score_many_vs_one(q2, [t2[i, : lens2[i]] for i in range(B2)])
            with tempfile.TemporaryDirectory() as td2:
                rd = Path(td2) / "cursors"
                r1 = run_multihost(
                    q2, t2, np.arange(B2, dtype=np.int32), nprocs=nprocs,
                    mode="database", lens=lens2, resume_dir=rd, device=device,
                )
                r2 = run_multihost(
                    q2, t2, np.arange(B2, dtype=np.int32), nprocs=nprocs,
                    mode="database", lens=lens2, resume_dir=rd, device=device,
                )
            outcomes.append(
                TestOutcome(
                    "resume_cursor", -1,
                    bool(np.array_equal(r1.scores, want2))
                    and bool(np.array_equal(r2.scores, want2))
                    and r2.resumed_shards == list(range(nprocs)),
                    f"rerun resumed shards {r2.resumed_shards}",
                )
            )
        if "lying_device" in cfg["tests"]:
            # one shard's worker returns wrong scores; run_multihost must
            # detect it (checksum / oracle audit) and score the shard again
            res = run_multihost(
                q, t, np.arange(B, dtype=np.int32), nprocs=nprocs,
                adversary_worker=nprocs - 1, adversary_mode="corrupt", device=device,
            )
            outcomes.append(
                TestOutcome(
                    "lying_device", -1,
                    res.bad_shards == [nprocs - 1]
                    and bool(np.array_equal(res.scores, want)),
                    f"bad_shards={res.bad_shards}",
                )
            )
    return outcomes


def main_cli(suite_path: Optional[str], device="cuda") -> int:
    """Print one PASS / FAIL / SKIP line an outcome and a summary; 1 on any
    failure that was not skipped (whatever the suite's "fail" says)."""
    t0 = time.time()
    outcomes = run_suite(suite_path, device=device)
    failed = [o for o in outcomes if not o.passed and not o.skipped]
    skipped = [o for o in outcomes if o.skipped]
    for o in outcomes:
        status = "SKIP" if o.skipped else ("PASS" if o.passed else "FAIL")
        extra = f"  ({o.detail})" if o.detail else ""
        print(f"{status} ds{o.dataset} {o.name}{extra}")
    ran = len(outcomes) - len(skipped)
    skip_note = f", {len(skipped)} skipped" if skipped else ""
    print(
        f"# {ran - len(failed)}/{ran} passed{skip_note} in "
        f"{time.time()-t0:.1f}s"
    )
    return 1 if failed else 0
