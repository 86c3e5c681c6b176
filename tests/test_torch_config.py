"""Port configs and seeded tables vs the JAX package (exact)."""

import dataclasses
import enum

import numpy as np
import pytest

from matchinglib_poselib_tpu import config as jcfg
from matchinglib_poselib_tpu.ops import features as jfeat
from matchinglib_poselib_tpu.ops import solvers as jsolv

from matchinglib_poselib_torch import config as tcfg, convert
from matchinglib_poselib_torch.ops import features as tfeat
from matchinglib_poselib_torch.ops import solvers as tsolv

import test_torch_helpers  # noqa: F401  (thread cap)


def _members(mod, kind):
    return {
        name: obj for name, obj in vars(mod).items()
        if isinstance(obj, type) and issubclass(obj, kind)
        and obj.__module__ == mod.__name__
    }


def _dataclasses(mod):
    return {
        name: obj for name, obj in vars(mod).items()
        if isinstance(obj, type) and dataclasses.is_dataclass(obj)
        and obj.__module__ == mod.__name__
    }


def test_same_dataclasses_fields_and_defaults():
    """Every config dataclass exists in both, with equal field names and
    equal defaults (nested configs and enums compared by value)."""
    jd, td = _dataclasses(jcfg), _dataclasses(tcfg)
    assert sorted(jd) == sorted(td)
    for name, jcls in jd.items():
        jf = [f.name for f in dataclasses.fields(jcls)]
        tf = [f.name for f in dataclasses.fields(td[name])]
        assert jf == tf, name
        assert convert.config_from_jax(jcls()) == td[name](), name


def test_same_enums_and_constants():
    je, te = _members(jcfg, enum.Enum), _members(tcfg, enum.Enum)
    assert sorted(je) == sorted(te)
    for name, jcls in je.items():
        assert [(m.name, m.value) for m in jcls] == [
            (m.name, m.value) for m in te[name]
        ]
    for const in ("PIX_MIN_GOOD_TH", "PIX_TH_START", "MIN_PIX_TH",
                  "MAX_PIX_TH", "LOWE_RATIO"):
        assert getattr(jcfg, const) == getattr(tcfg, const)


def test_config_from_jax_round_trips_non_defaults():
    jp = jcfg.PoseConfig(
        robust=jcfg.RobustConfig(
            batch_hypotheses=96, max_batches=12,
            estimator=jcfg.PoseEstimator.PROSAC,
            solver=jcfg.MinimalSolver.EIGHT_PT,
        ),
        refine=jcfg.RefinementConfig(weights=jcfg.RefineWeights.TORR,
                                     refine_max_points=None),
        auto_th=True,
    )
    tp = convert.config_from_jax(jp)
    assert isinstance(tp, tcfg.PoseConfig)
    assert tp.robust.batch_hypotheses == 96 and tp.robust.max_batches == 12
    assert tp.robust.estimator is tcfg.PoseEstimator.PROSAC
    assert tp.robust.solver is tcfg.MinimalSolver.EIGHT_PT
    assert tp.refine.weights is tcfg.RefineWeights.TORR
    assert tp.refine.refine_max_points is None and tp.auto_th
    det = convert.config_from_jax(
        jcfg.DetectorConfig(kind="FAST", max_keypoints=2048,
                            fast_threshold=12.0)
    )
    assert det == tcfg.DetectorConfig(kind="FAST", max_keypoints=2048,
                                      fast_threshold=12.0)


def test_seeded_tables_equal_exactly():
    """BRIEF pattern, ORB selection table and 5pt interpolation constants
    regenerate bit for bit (atol 0)."""
    np.testing.assert_array_equal(
        tfeat.brief_pattern(), np.asarray(jfeat._BRIEF_PTS))
    np.testing.assert_array_equal(tfeat.orb_selection_tables(),
                                  jfeat._ORB_IDX)
    pts64 = tsolv.pick_interpolation_points()
    np.testing.assert_array_equal(pts64, jsolv._PTS64)
    tables = tsolv.SolverTables()
    np.testing.assert_array_equal(tables.interp_pts.numpy(),
                                  np.asarray(jsolv._INTERP_PTS))
    np.testing.assert_array_equal(tables.vinv_t_nister.numpy(),
                                  np.asarray(jsolv._VINV_T_NISTER))
    np.testing.assert_array_equal(
        tfeat.DescriptorTables().orb_idx.numpy(), jfeat._ORB_IDX)


def test_tables_from_numpy_loads_the_jax_arrays():
    dt, st = convert.tables_from_numpy(
        jfeat._ORB_IDX, np.asarray(jsolv._INTERP_PTS),
        np.asarray(jsolv._VINV_T_NISTER),
    )
    np.testing.assert_array_equal(dt.orb_idx.numpy(), jfeat._ORB_IDX)
    np.testing.assert_array_equal(st.interp_pts.numpy(),
                                  np.asarray(jsolv._INTERP_PTS))
    np.testing.assert_array_equal(st.vinv_t_nister.numpy(),
                                  np.asarray(jsolv._VINV_T_NISTER))


def test_config_from_jax_rejects_unknown_dataclass():
    @dataclasses.dataclass(frozen=True)
    class NotAConfig:
        x: int = 1

    with pytest.raises(AttributeError):
        convert.config_from_jax(NotAConfig())
