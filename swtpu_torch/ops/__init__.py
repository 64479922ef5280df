"""The port's scoring ops: the streamed wavefront (``stream``), the
bucketed column kernels (``column``), the lane-major column kernel of the
kernel shootout (``lane``), the microbenchmarks' kernels (``microbench``),
their CUDA kernels' build (``_build``) and the sentinel contract
(``common``)."""
