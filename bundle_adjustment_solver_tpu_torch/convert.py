"""Carry problems built by the JAX package into this package.

The JAX package's `PointMajorProblem`, `PMShape`, `CameraRig` and poses,
and its batched pose-only problems, handed over as numpy arrays and plain
dicts (this package imports nothing of the JAX package), become this
package's tensors, so both packages can run on identical inputs.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .device import resolve_device
from .models.camera import CameraRig
from .models.layout import PMShape, PointMajorProblem
from .ops.cuda.full_ba_pm import pose_table

_INT_FIELDS = ("slot_pose", "slot_opt", "point_ref", "gbase", "sbase")


def batched_problem_tensors(
    arrays: Mapping[str, np.ndarray | None],
    device: torch.device | str | None,
) -> dict[str, torch.Tensor | None]:
    """A batched pose-only problem of the JAX package (or of this package's
    generators, which give the same arrays), handed over as numpy arrays by
    field name, as this package's tensors on `device`: float arrays become
    float32 (rounded as the JAX package rounds them), bool arrays stay bool,
    and absent fields (None, e.g. the right pixels of a mono problem) stay
    None. Feeding `tensor.cpu().numpy()` of the result to the JAX package
    gives both packages bit-identical inputs."""
    device = resolve_device(device)
    out = {}
    for name, a in arrays.items():
        if a is None:
            out[name] = None
            continue
        a = np.asarray(a)
        dtype = torch.bool if a.dtype == np.bool_ else torch.float32
        out[name] = torch.as_tensor(a, dtype=dtype, device=device)
    return out


def from_jax_numpy(
    pm_arrays: Mapping[str, np.ndarray],
    pshape_fields: Mapping[str, object],
    rig_arrays: Mapping[str, np.ndarray],
    R_cw: np.ndarray,
    t_cw: np.ndarray,
    device: torch.device | str | None,
) -> tuple[PointMajorProblem, PMShape, CameraRig, torch.Tensor]:
    """(pm, pshape, rig, pose_tbl) on `device` from the JAX package's
    layout arrays (`PointMajorProblem` fields by name), `PMShape` fields,
    `CameraRig` fields and scaled (N, 3, 3) / (N, 3) poses. The pose table is
    the (N + P, 16) table the solver carries."""
    device = resolve_device(device)

    def tensor(name, a):
        dtype = torch.int32 if name in _INT_FIELDS else torch.float32
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    pm = PointMajorProblem(
        **{name: tensor(name, pm_arrays[name])
           for name in PointMajorProblem._fields}
    )
    pshape = PMShape(**dict(pshape_fields))
    rig = CameraRig(
        **{name: torch.tensor(np.asarray(rig_arrays[name]),
                              dtype=torch.float32, device=device)
           for name in CameraRig._fields}
    )
    f32 = dict(dtype=torch.float32, device=device)
    tbl = pose_table(torch.tensor(np.asarray(R_cw), **f32),
                     torch.tensor(np.asarray(t_cw), **f32), pshape.window)
    return pm, pshape, rig, tbl
