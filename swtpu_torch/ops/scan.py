"""Batched Smith-Waterman scoring as a loop over target columns.

The port of ``swtpu.ops.scan``: the portable formulation of the
recurrence, on the tensors' device.  The batch of pairs is the vector
dimension and one step of a Python loop computes an entire DP column (all
query rows) of every pair at once, where swtpu runs ``lax.scan``.

The intra-column serial dependency of the merged in-del matrix

    I[i][j] = max(base[i], I[i-1][j] + gap_extend)

is a max-plus prefix along the query, evaluated in log2(m) Hillis-Steele
steps of shift, add and max.  State stays int32 throughout, as swtpu's.

Inputs follow the sentinel-padding contract (``swtpu_torch.ops.common``):
pads never match, so no masks appear anywhere in the recurrence.  This is
no Pallas kernel in swtpu and no CUDA kernel here: torch's own elementwise
ops run each step.
"""

from __future__ import annotations

import torch

from swtpu_torch.config import DEFAULT_PENALTIES, Penalties

NEG = torch.iinfo(torch.int32).min // 4  # the prefix fill: never wins


def _shift_down(x: torch.Tensor, fill) -> torch.Tensor:
    """Shift one step along the query axis (axis 1): out[:, 0] = fill,
    out[:, i] = x[:, i-1]."""
    pad = torch.full((x.shape[0], 1), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[:, :-1]], dim=1)


def _maxplus_prefix(base: torch.Tensor, ge: int) -> torch.Tensor:
    """I[i] = max_{k<=i} base[k] + (i-k)*ge, in log2(m) steps."""
    m = base.shape[1]
    x = base
    shift = 1
    while shift < m:
        pad = torch.full((x.shape[0], shift), NEG, dtype=x.dtype, device=x.device)
        shifted = torch.cat([pad, x[:, :-shift]], dim=1)
        x = torch.maximum(x, shifted + shift * ge)
        shift *= 2
    return x


def sw_scores_scan(q, t, penalties: Penalties = DEFAULT_PENALTIES) -> torch.Tensor:
    """Score a batch of (query, target) pairs.

    Args:
      q: [B, m] base codes, sentinel-padded (Q_PAD): a tensor, or an array
        that ``torch.as_tensor`` takes.
      t: [B, n] base codes, sentinel-padded (T_PAD), on q's device.
      penalties: scoring penalties.

    Returns: [B] int32 local-alignment scores on q's device.
    """
    ma, mi, go, ge = penalties.astuple()
    dt = torch.int32
    q = torch.as_tensor(q).to(dt)
    t = torch.as_tensor(t).to(device=q.device, dtype=dt)
    B, m = q.shape
    dev = q.device
    # Boundary I[-1][j] = 0 (the RTL ties every chain input to ZERO): the
    # candidate 0 + extend of row 0 of every column's prefix
    i0_bias = torch.full((1, m), NEG, dtype=dt, device=dev)
    if m:
        i0_bias[0, 0] = ge
    # boundary column j = -1: M = I = 0 (the RTL's ZERO tie), H = 0
    M = torch.zeros((B, m), dtype=dt, device=dev)
    I = torch.zeros((B, m), dtype=dt, device=dev)
    H = torch.zeros((B, m), dtype=dt, device=dev)
    ma_t = torch.tensor(ma, dtype=dt, device=dev)
    mi_t = torch.tensor(mi, dtype=dt, device=dev)
    for j in range(t.shape[1]):
        s = torch.where(q == t[:, j : j + 1], ma_t, mi_t)
        diag_s = _shift_down(torch.maximum(M, I), 0)
        M_new = torch.clamp_min(diag_s + s, 0)
        M_up = _shift_down(M_new, 0)
        base = torch.maximum(
            torch.maximum(M_up, M) + (go + ge),
            torch.maximum(I + ge, i0_bias),
        )
        I = _maxplus_prefix(base, ge)
        M = M_new
        H = torch.maximum(H, M_new)
    if m == 0:
        return torch.zeros((B,), dtype=dt, device=dev)
    return H.max(dim=1).values
