"""PyTorch and CUDA port of the bundle-adjustment engine.

A second package beside the JAX one (`bundle_adjustment_solver_tpu`, the
reference this port is held against). It runs full bundle adjustment on the
point-major engine and the fused batched pose-only solvers (all four
modes) with hand-written CUDA kernels for Hopper (sm_90a); CPU tensors take
the kernels' plain PyTorch versions. Entry points run on the CUDA card
unless the caller passes ``device="cpu"``.

    from bundle_adjustment_solver_tpu_torch import (
        Options, corridor_ba_problem, pm_problem_from_arrays, solve_pm)
    from bundle_adjustment_solver_tpu_torch import (
        batched_stereo_pose_only_problem, solve_stereo_6dof_batched)
"""

from .models.camera import stereo_rig
from .options import Options
from .solvers.full_ba_pm import pm_problem_from_arrays, solve_pm
from .solvers.pose_only import (
    PoseOnlyResult,
    solve_monocular_6dof_batched,
    solve_monocular_planar3dof_batched,
    solve_stereo_6dof_batched,
    solve_stereo_planar3dof_batched,
)
from .utils.synthetic import (
    batched_planar_pose_only_problem,
    batched_stereo_pose_only_problem,
    corridor_ba_problem,
)

__all__ = [
    "Options",
    "stereo_rig",
    "pm_problem_from_arrays",
    "solve_pm",
    "corridor_ba_problem",
    "PoseOnlyResult",
    "solve_monocular_6dof_batched",
    "solve_stereo_6dof_batched",
    "solve_monocular_planar3dof_batched",
    "solve_stereo_planar3dof_batched",
    "batched_stereo_pose_only_problem",
    "batched_planar_pose_only_problem",
]
