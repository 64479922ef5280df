"""The port's scoring ops: the streamed wavefront (``stream``), its CUDA
kernel's build (``_build``) and the sentinel contract (``common``)."""
