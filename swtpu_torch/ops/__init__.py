"""The port's scoring ops: the streamed wavefront (``stream``), the
bucketed column kernels (``column``), their CUDA kernels' build
(``_build``) and the sentinel contract (``common``)."""
