"""PyTorch and CUDA port of the bundle-adjustment engine.

A second package beside the JAX one (`bundle_adjustment_solver_tpu`, the
reference this port is held against). It runs full bundle adjustment on the
point-major engine with hand-written CUDA kernels for Hopper (sm_90a); CPU
tensors take the kernels' plain PyTorch versions. Entry points run on the
CUDA card unless the caller passes ``device="cpu"``.

    from bundle_adjustment_solver_tpu_torch import (
        Options, corridor_ba_problem, pm_problem_from_arrays, solve_pm)
"""

from .models.camera import stereo_rig
from .options import Options
from .solvers.full_ba_pm import pm_problem_from_arrays, solve_pm
from .utils.synthetic import corridor_ba_problem

__all__ = [
    "Options",
    "stereo_rig",
    "pm_problem_from_arrays",
    "solve_pm",
    "corridor_ba_problem",
]
