"""Hand-written CUDA kernels of the port, each beside its plain version:

* ``led_matmul`` — the fused LED product ``(x @ A) @ B``;
* ``paged_attention`` — single-query decode attention read from the paged
  KV pool through the block table;
* ``chunk_attention`` — one slot's prefill-chunk attention over its
  resident prefix and its own K/V.

Importing this package builds nothing: a kernel is compiled with ``nvcc``
at its first launch on a CUDA tensor (see ``_build``)."""
