"""Device timers for the card's measurements (``chip_smoke.py`` and
``experiments/torch_*.py``), on CUDA events."""

from __future__ import annotations

import torch


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_once(fn):
    """(fn(), its device time in ms) for one call, no warm-up: for a plain
    version, whose one call at a main-path shape can take minutes."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def graph_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls captured in one CUDA
    graph and replayed (after one warm-up call and one warm-up replay): the
    launches run back to back with no host work between them, so this is
    the kernels' own time where a call's host work outlasts its kernels
    (cuda_ms then times the host's enqueue)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
