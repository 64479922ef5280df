"""The port's scoring ops: the streamed wavefront (``stream``), the
bucketed column kernels (``column``), the lane-major column kernel of the
kernel shootout (``lane``), the scan (``scan``), the microbenchmarks'
kernels (``microbench``), their CUDA kernels' build (``_build``) and the
sentinel contract (``common``).

swtpu's names of its Pallas entries stay as aliases of their
counterparts: ``sw_scores_pallas`` is ``sw_scores_column`` and
``sw_scores_pallas_lane`` is ``sw_scores_lane``."""

from swtpu_torch.ops.column import sw_scores_column
from swtpu_torch.ops.common import Q_PAD, T_PAD, pad_to_static, sentinel_pad_batch
from swtpu_torch.ops.lane import sw_scores_lane
from swtpu_torch.ops.scan import sw_scores_scan
from swtpu_torch.ops.stream import sw_scores_stream_strip

sw_scores_pallas = sw_scores_column
sw_scores_pallas_lane = sw_scores_lane

__all__ = [
    "Q_PAD",
    "T_PAD",
    "pad_to_static",
    "sentinel_pad_batch",
    "sw_scores_scan",
    "sw_scores_pallas",
    "sw_scores_pallas_lane",
    "sw_scores_stream_strip",
    "sw_scores_column",
    "sw_scores_lane",
]
