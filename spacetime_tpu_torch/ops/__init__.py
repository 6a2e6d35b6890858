"""Device operators on tensors: stencils, the B/Bᵀ kernels and their plain
twins, the wavelet-in-time transform and multi-shift multigrid."""
