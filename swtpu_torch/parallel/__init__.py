"""Scoring across devices and processes: the mesh (``mesh``), the sharded
scorers and the merged top-K (``sharded``), the one-device top-k cut
(``topk``) and the multi-process job on ``torch.distributed``
(``multihost``)."""

from swtpu_torch.parallel.mesh import Mesh, make_mesh
from swtpu_torch.parallel.sharded import (
    make_sharded_scorer,
    make_sharded_stream_scorer,
    make_sharded_topk,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "make_sharded_scorer",
    "make_sharded_stream_scorer",
    "make_sharded_topk",
]
