"""Hand-written CUDA kernels (``csrc/``) and their plain PyTorch versions.

Each wrapper keeps a launch counter (``<wrapper>.launches``) that it bumps
only where it launches its kernel.  The MX matmul and the paged decode
attention, which a per-layer policy table runs at several formats, also
count there by spec (``launches_by_spec``: QuantSpec, or the (key,
value) pair, -> launches)."""
