"""spacetime_tpu_torch — the space-time heat-equation solver on PyTorch and CUDA.

A port of ``spacetime_tpu`` (the JAX package, which stays the reference) to
one NVIDIA H100. The host side is shared: meshes, P1 assembly, time grids,
the wavelet structure and the multigrid hierarchy are imported from
``spacetime_tpu`` modules that need no JAX. The device side is PyTorch, and
the space-time operator B and its adjoint Bᵀ — Pallas kernels in the JAX
package — are CUDA kernels written for ``sm_90a`` (``csrc/kron.cu``).

The first slice covers the structured 2-D main path: constant stencils,
multi-shift geometric multigrid inner solves, standard PCG on uniform dyadic
time grids, and mixed-precision refinement with native f64 residual legs.

- ``models``  — problems with exact solutions as torch functions;
- ``ops``     — stencils, the B/Bᵀ kernels and their plain twins, the
                wavelet transform and the multigrid V-cycle;
- ``solver``  — PCG and ``HeatSolver``;
- ``convert`` — the JAX solver's params in the port's layout (tests);
- ``run``     — the command-line interface (``python -m spacetime_tpu_torch``).
"""

__version__ = "0.1.0"
