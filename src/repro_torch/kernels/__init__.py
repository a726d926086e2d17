"""Hand-written CUDA kernels (``csrc/``) and their plain PyTorch versions.

Each wrapper keeps a launch counter (``<wrapper>.launches``) that it bumps
only where it launches its kernel."""
