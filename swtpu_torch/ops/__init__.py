"""The port's scoring ops: the streamed wavefront (``stream``), its CUDA
kernels' build (``_build``) and the sentinel contract (``common``)."""
