"""spacetime_tpu_torch — the space-time heat-equation solver on PyTorch and CUDA.

A port of ``spacetime_tpu`` (the JAX package, which stays the reference) to
one NVIDIA H100. It imports nothing of the JAX package: the host code it
needs (meshes, P1 assembly, load quadrature, time grids, the wavelet
structure, the multigrid hierarchy) is its own copy, kept bit-for-bit equal
to the JAX package's by the tests. The device side is PyTorch, and the
Pallas kernels of the JAX package on its path are CUDA kernels written for
``sm_90a``: B and Bᵀ (``csrc/kron.cu``), the multigrid V-cycle kernels
(``csrc/mg.cu``) and the blocked-ELL SpMM (``csrc/ell.cu``).

The port covers uniform dyadic time grids in 2-D and 3-D: constant stencils
(``smooth2d``, ``smooth3d``, ``moving_peak2d``), coefficient-weighted
problems (``varcoef2d``, ``varcoef3d``: per-node A weights and the Galerkin
multigrid hierarchy) and the L-shaped domain (``lshape2d``: the flat DIA or
blocked-ELL formats); dense, Chebyshev and multigrid inner solves; standard
PCG and mixed-precision refinement with native f64 residual legs.

- ``fem``     — structured meshes and the L-shape, P1 assembly, loads,
                time grids, L2 error;
- ``models``  — problems with exact solutions as torch functions;
- ``ops``     — stencils, DIA and blocked ELL, the kernels and their plain
                twins, the wavelet transform, the multigrid hierarchy and
                V-cycle, the Chebyshev helpers;
- ``solver``  — PCG and ``HeatSolver``;
- ``parallel`` — meshes of ranks on ``torch.distributed``: the explicit
                time-sharded and time × space solvers;
- ``convert`` — the JAX solver's params in the port's layout (tests);
- ``run``     — the command-line interface (``python -m spacetime_tpu_torch``).
"""

__version__ = "0.1.0"
