"""State carried across from the JAX package: configs and seeded tables.

The system has no trained weights; its parameters are configs and tables
that both packages generate from the same numpy code and seeds.

- ``config_from_jax`` turns any JAX-package config dataclass (enums and
  nested configs included) into the port's equivalent. It reads plain
  attributes and imports nothing from jax.
- ``tables_from_numpy`` loads the ORB selection table and the 5pt
  interpolation constants from numpy arrays onto a device.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from matchinglib_poselib_torch import config as _config
from matchinglib_poselib_torch.ops.features import DescriptorTables
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
    device: torch.device | str = "cpu",
) -> tuple[DescriptorTables, SolverTables]:
    """Descriptor and solver tables from numpy arrays.

    orb_idx: (30, 512) int flat patch indices of the rotated BRIEF pattern
    (the JAX package's ``features._ORB_IDX``); interp_pts (20, 3) and
    vinv_t_nister (20, 20): the 5pt interpolation points and transposed
    inverse Nister Vandermonde (``solvers._INTERP_PTS``,
    ``solvers._VINV_T_NISTER``).
    """
    return (
        DescriptorTables(np.asarray(orb_idx), device=device),
        SolverTables(np.asarray(interp_pts), np.asarray(vinv_t_nister),
                     device=device),
    )
