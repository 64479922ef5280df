"""Multi-process scoring worker: one simulated host.

The port of ``swtpu.testing.worker``.  The localhost harness
(``swtpu_torch.testing.regress``) runs N of these as OS processes joined
by ``torch.distributed`` (gloo); each owns a shard of the rows, scores it
on its device and takes part in the merged top-K, and the driver checks
that every worker reports the same merged result.

    python -m swtpu_torch.testing.worker --coordinator HOST:PORT \\
        --nprocs N --pid I --input in.npz --output out.npz [--topk K] \\
        [--lo L --hi H] [--cursor shard.npz --cursor-fp FP] \\
        [--delay-ms MS] [--adversary corrupt|corrupt_wire] [--device cuda|cpu]

With ``--device cuda`` (the default) and no GPU it exits non-zero; it never
carries on on the CPU.  Its output holds swtpu's fields and the launch
counts of the wavefront, chained-tile and column kernels' wrappers in this
process, which show that the kernels ran in the worker.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--topk", type=int, default=4)
    ap.add_argument(
        "--lo", type=int, default=-1,
        help="explicit shard row range [lo, hi) — ragged shard sizes "
        "(database mode; default: equal split)",
    )
    ap.add_argument("--hi", type=int, default=-1)
    ap.add_argument("--cursor-fp", type=int, default=0,
                    help="job fingerprint stored in the cursor")
    ap.add_argument(
        "--cursor", default="",
        help="per-shard completion cursor file: written atomically once this "
        "shard's scores exist, so a rerun driver can resume the shard from disk",
    )
    ap.add_argument("--delay-ms", type=int, default=0, help="injected startup delay")
    ap.add_argument(
        "--adversary", default="", choices=["", "corrupt", "corrupt_wire"],
        help="act as a lying device: 'corrupt' returns wrong scores with a "
        "consistent checksum (caught by the driver's oracle audit); "
        "'corrupt_wire' corrupts after checksumming (caught by the checksum "
        "cross-check)",
    )
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where this worker scores (cuda: every visible GPU)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("worker: --device cuda, but no CUDA device is available", file=sys.stderr)
        return 2
    if args.device == "cpu":
        torch.set_num_threads(1)

    import torch.distributed as dist

    from swtpu_torch.parallel.mesh import make_mesh
    from swtpu_torch.parallel.multihost import initialize
    from swtpu_torch.parallel.sharded import make_sharded_topk
    from swtpu_torch.utils.guards import checksum

    initialize(args.coordinator, args.nprocs, args.pid)
    if args.delay_ms:
        time.sleep(args.delay_ms / 1e3)
    mesh = make_mesh() if args.device == "cuda" else make_mesh(devices=["cpu"])

    data = np.load(args.input)
    mode = str(data["mode"]) if "mode" in data else "pairs"
    q, t, ids = data["q"], data["t"], data["ids"]
    B = t.shape[0]
    if args.lo >= 0:
        # a ragged explicit shard (database mode): the stream path agrees
        # the cross-process geometry itself
        lo, hi = args.lo, args.hi
    else:
        assert B % (mesh.size * args.nprocs) == 0, (B, mesh.size * args.nprocs)
        rows_each = B // args.nprocs
        lo, hi = args.pid * rows_each, (args.pid + 1) * rows_each

    if mode == "database":
        # one replicated query, this process's shard of the database, the
        # stream backend, the dense (mat, lens) form end to end
        from swtpu_torch.parallel.multihost import score_database_multihost

        lens = data["lens"]
        top_s, top_ids, local_scores = score_database_multihost(
            q, (t[lo:hi], lens[lo:hi]), ids[lo:hi], mesh=mesh, k=args.topk
        )
        local_rows = np.arange(lo, hi)
        if args.cursor:
            # the shard's completion cursor: scores, rows and checksum,
            # written atomically (tmp, then rename) the moment they exist
            tmp = args.cursor + ".tmp.npz"
            with open(tmp, "wb") as f:
                np.savez(f, local_rows=local_rows, local_scores=local_scores,
                         checksum=checksum(np.asarray(local_scores)),
                         job_fp=args.cursor_fp)
            os.replace(tmp, args.cursor)
    else:
        topk = make_sharded_topk(mesh, k=args.topk)
        top_s, top_ids, scores = topk(q[lo:hi], t[lo:hi], ids[lo:hi])
        top_s, top_ids = top_s.cpu().numpy(), top_ids.cpu().numpy()
        local_scores = scores.cpu().numpy()
        local_rows = np.arange(lo, hi)
    dist.destroy_process_group()

    if args.adversary == "corrupt":
        # a lying device: plausible wrong scores, the checksum taken after
        # the lie so that the wire check passes — only the driver's oracle
        # audit catches this
        local_scores = local_scores + 37
        csum = checksum(local_scores)
    elif args.adversary == "corrupt_wire":
        # corruption between compute and the result's transfer: the
        # checksum is of the true scores, the payload differs
        csum = checksum(local_scores)
        local_scores = local_scores ^ 0x55
    else:
        csum = checksum(local_scores)

    from swtpu_torch.ops.column import column_chained_cuda, column_scores_cuda
    from swtpu_torch.ops.stream import chained_launches, stream_strip_cuda

    np.savez(
        args.output,
        top_s=np.asarray(top_s),
        top_ids=np.asarray(top_ids),
        local_scores=local_scores,
        local_rows=local_rows,
        pid=args.pid,
        checksum=csum,
        launches_wavefront=stream_strip_cuda.launches,
        launches_chained=chained_launches(),
        launches_column=column_scores_cuda.launches,
        launches_column_chained=column_chained_cuda.launches,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
