"""State carried across from the JAX package: configs and seeded tables.

The system has no trained weights; its parameters are configs and tables
that both packages generate from the same numpy code and seeds.

- ``config_from_jax`` turns any JAX-package config dataclass (enums and
  nested configs included) into the port's equivalent. It reads plain
  attributes and imports nothing from jax.
- ``tables_from_numpy`` loads the ORB selection table and the 5pt
  interpolation constants (both solvers' orders) from numpy arrays onto a
  device.
- ``pool_from_numpy`` loads a streaming correspondence pool (the state
  ``StereoRefine`` carries across frames, as the JAX package's
  checkpoint stores it) from numpy arrays onto a device.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from matchinglib_poselib_torch import config as _config
from matchinglib_poselib_torch.ops.features import DescriptorTables
from matchinglib_poselib_torch.ops.pool import Pool
from matchinglib_poselib_torch.ops.solvers import SolverTables


def config_from_jax(cfg):
    """The port's counterpart of a JAX-package config value.

    Dataclasses map by class name, enums by class name and value; other
    values (numbers, strings, None) pass through.
    """
    if isinstance(cfg, enum.Enum):
        return getattr(_config, type(cfg).__name__)(cfg.value)
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        cls = getattr(_config, type(cfg).__name__)
        return cls(**{
            f.name: config_from_jax(getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)
        })
    return cfg


def tables_from_numpy(
    orb_idx: np.ndarray,
    interp_pts: np.ndarray,
    vinv_t_nister: np.ndarray,
    vinv_t_stewenius: np.ndarray | None = None,
    device: torch.device | str = "cpu",
) -> tuple[DescriptorTables, SolverTables]:
    """Descriptor and solver tables from numpy arrays.

    orb_idx: (30, 512) int flat patch indices of the rotated BRIEF pattern
    (the JAX package's ``features._ORB_IDX``); interp_pts (20, 3),
    vinv_t_nister and vinv_t_stewenius (20, 20): the 5pt interpolation
    points and the transposed inverse Vandermonde matrices in Nister and
    Stewenius order (``solvers._INTERP_PTS``, ``solvers._VINV_T_NISTER``,
    ``solvers._VINV_T``; the Stewenius table regenerated from the seed
    when None).
    """
    return (
        DescriptorTables(np.asarray(orb_idx), device=device),
        SolverTables(np.asarray(interp_pts), np.asarray(vinv_t_nister),
                     None if vinv_t_stewenius is None
                     else np.asarray(vinv_t_stewenius), device=device),
    )


def pool_from_numpy(arrays, device: torch.device | str = "cpu") -> Pool:
    """A ``Pool`` from a mapping of its field names to numpy arrays (the
    JAX package's ``Pool`` fields, slot for slot): floats as float32,
    counters as int32, masks as bool, on `device`."""
    out = {}
    for name in Pool._fields:
        a = np.asarray(arrays[name])
        if a.dtype == np.bool_:
            dt = torch.bool
        elif np.issubdtype(a.dtype, np.integer):
            dt = torch.int32
        else:
            dt = torch.float32
        out[name] = torch.from_numpy(np.array(a)).to(device=device,
                                                       dtype=dt)
    return Pool(**out)
