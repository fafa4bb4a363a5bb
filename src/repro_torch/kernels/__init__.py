"""Hand-written CUDA kernels of the port, each beside its plain version
(``led_matmul``: the fused LED product).

Importing this package builds nothing: a kernel is compiled with ``nvcc``
at its first launch on a CUDA tensor (see ``_build``)."""
