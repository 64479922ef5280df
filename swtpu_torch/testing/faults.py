"""Seeded fault injection for the hardware-free test harness.

The port of ``swtpu.testing.faults``, after PSLSE's randomized adversarial
backend (its SEED, PAGED_PERCENT, REORDER_PERCENT and BUFFER_PERCENT
parameters): batch submissions can be reordered, transiently dropped
(forcing a retry), delayed, and corrupted between the packer and the
device or between the device and the scatter.  One seed drives it all, so
a failure reproduces; the random draws come in swtpu's order, so the same
seed over the same batches injects the same faults in both packages.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List

import numpy as np


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """PSLSE's parameters.  Percentages in [0, 100]."""

    seed: int = 1234
    reorder_percent: int = 0  # shuffle the batches' submission order
    drop_percent: int = 0  # fail a submission transiently (retried)
    max_retries: int = 5
    delay_ms_min: int = 0
    delay_ms_max: int = 0
    # a flipped value between pack and dispatch ("codes") or between score
    # and scatter ("scores"), which the integrity guards must catch
    corrupt_percent: int = 0
    corrupt_kind: str = "codes"  # "codes" | "scores"


class TransientFault(RuntimeError):
    pass


class FaultInjector:
    """Wraps a batch scorer fn(q, t) -> scores with seeded adversity."""

    def __init__(self, config: FaultConfig):
        self.config = config
        self.rng = np.random.default_rng(config.seed)
        self.injected_drops = 0
        self.injected_reorders = 0
        self.injected_corruptions = 0

    def corrupt_codes(self, t: np.ndarray) -> np.ndarray:
        """Maybe turn one packed base code into garbage, as a bit flipped
        on the wire between the packer and the device would."""
        if self.rng.integers(100) >= self.config.corrupt_percent:
            return t
        t = t.copy()
        i = int(self.rng.integers(t.shape[0]))
        j = int(self.rng.integers(t.shape[1]))
        t[i, j] = 9  # neither a base code nor a sentinel
        self.injected_corruptions += 1
        return t

    def corrupt_scores(self, s: np.ndarray, bound: int) -> np.ndarray:
        """Maybe lift one result past its algebraic bound, as a bit flipped
        on the way back would."""
        if self.rng.integers(100) >= self.config.corrupt_percent:
            return s
        s = np.asarray(s).copy()
        i = int(self.rng.integers(len(s)))
        s[i] = bound + 1 + int(s[i])
        self.injected_corruptions += 1
        return s

    def order(self, n_batches: int) -> List[int]:
        order = list(range(n_batches))
        if self.rng.integers(100) < self.config.reorder_percent:
            self.rng.shuffle(order)
            if order != sorted(order):
                self.injected_reorders += 1
        return order

    def submit(self, fn: Callable, *args):
        cfg = self.config
        if cfg.delay_ms_max > 0:
            delay = self.rng.integers(cfg.delay_ms_min, cfg.delay_ms_max + 1)
            time.sleep(delay / 1e3)
        for attempt in range(cfg.max_retries + 1):
            if attempt < cfg.max_retries and self.rng.integers(100) < cfg.drop_percent:
                self.injected_drops += 1
                continue  # a dropped submission: retry
            return fn(*args)
        raise TransientFault("exceeded max retries")


def score_database_with_faults(bank, query: np.ndarray, targets, faults: FaultConfig):
    """ScoreBank.score_database's bucket batches under adversarial
    scheduling: the batches run in a fault-injected order with transient
    drops and retries, and the scores must still land in read order.
    With ``bank.verify_integrity`` the port's guards check each batch
    before dispatch and each batch's scores after it.  Returns (scores,
    the injector)."""
    from swtpu_torch.bank.packer import pack_many_vs_one
    from swtpu_torch.utils.guards import (
        check_packed_query, check_packed_target, check_scores,
    )

    inj = FaultInjector(faults)
    batches = pack_many_vs_one(query, targets, bucket_lens=bank.config.target_buckets)
    scores = np.zeros((len(targets),), dtype=np.int32)
    match = bank.config.penalties.match
    for bi in inj.order(len(batches)):
        batch = batches[bi]
        t = batch.t
        if faults.corrupt_percent and faults.corrupt_kind == "codes":
            t = inj.corrupt_codes(t)
        if bank.verify_integrity:
            # a corrupted batch must be caught here, before dispatch
            check_packed_query(batch.q, batch.q_lens)
            check_packed_target(t, batch.t_lens)
        s = inj.submit(bank._score_batch, batch.q, t)
        if faults.corrupt_percent and faults.corrupt_kind == "scores":
            s = inj.corrupt_scores(s, match * int(batch.q_lens.max()))
        if bank.verify_integrity:
            check_scores(s, batch.q_lens, batch.t_lens, match)
        live = batch.ids >= 0
        scores[batch.ids[live]] = s[live]
    return scores, inj
