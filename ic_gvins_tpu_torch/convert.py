"""Carry state across from the JAX package.

The frontend has no learned weights. Its state is the camera (packed by the
reference as a 10-vector, ``ic_gvins_tpu/vision/tracking.py:199-201``), the
config (a plain dataclass, parsed the same way by ``engine/config.py``) and
the image pyramids. The backend's state is the estimator's: navigation
states, the IMU model, the window parameters, the factor tables with their
marginalization prior, and preintegration summaries. Inputs are numpy arrays
or NamedTuples of numpy arrays (for example ``jax.tree_util.tree_map(
np.asarray, tree)`` of a JAX pytree), matched to the port's types by field
name, so this module needs no jax.
"""

import numpy as np
import torch

from .core.types import IntegrationParams, NavState
from .ins.preintegration import PreintSummary
from .ins.preintegration_odo import PreintOdoSummary
from .solver.problem import (
    FactorTables,
    GnssTable,
    MargPrior,
    PreintTable,
    PriorTable,
    ReprojTable,
    WindowParams,
)
from .vision.camera import PinholeCamera

# fields that hold a nested NamedTuple, by name
_NESTED = {"gnss": GnssTable, "preint": PreintTable, "reproj": ReprojTable, "prior": PriorTable,
           "marg": MargPrior, "summ": PreintSummary, "x0": WindowParams}


def _has(tree, name):
    return name in tree if isinstance(tree, dict) else hasattr(tree, name)


def _summary_cls(tree):
    """PreintOdoSummary for a summary with the odometer fields."""
    return PreintOdoSummary if _has(tree, "ds") else PreintSummary


def camera_from_vec(vec10, width, height):
    """The reference's packed camera [fx, fy, cx, cy, skew, k1, k2, k3, p1, p2]
    -> the port's ``PinholeCamera``."""
    v = [float(x) for x in np.asarray(vec10, np.float64).reshape(10)]
    return PinholeCamera(*v, width=int(width), height=int(height))


def pyramid_from_numpy(levels, device="cuda"):
    """A list of numpy pyramid levels -> the port's pyramid: contiguous f32
    tensors on ``device`` (the card unless the caller asks for the CPU),
    copied (never aliased with the numpy buffers)."""
    return [torch.tensor(np.asarray(lv), dtype=torch.float32, device=device) for lv in levels]


def _tree(cls, tree, device):
    """``cls`` from the same-named fields (or keys) of ``tree``: integer
    arrays become int64 (index) tensors, everything else float64; copies on
    ``device``."""
    out = {}
    for name in cls._fields:
        v = tree[name] if isinstance(tree, dict) else getattr(tree, name)
        if name == "summ":
            out[name] = _tree(_summary_cls(v), v, device)
        elif name in _NESTED:
            out[name] = _tree(_NESTED[name], v, device)
        else:
            a = np.asarray(v)
            dtype = torch.long if np.issubdtype(a.dtype, np.integer) else torch.float64
            out[name] = torch.tensor(a, dtype=dtype, device=device)
    return cls(**out)


def nav_state(tree, device="cuda"):
    return _tree(NavState, tree, device)


def integration_params(tree, device="cuda"):
    return _tree(IntegrationParams, tree, device)


def window_params(tree, device="cuda"):
    return _tree(WindowParams, tree, device)


def factor_tables(tree, device="cuda"):
    """FactorTables, its MargPrior included."""
    return _tree(FactorTables, tree, device)


def preint_summary(tree, device="cuda"):
    """A PreintSummary, or a PreintOdoSummary (the ``PreintOdoSummary``
    fields ds, sodo0, ds_dbg, ds_dsodo present)."""
    return _tree(_summary_cls(tree), tree, device)


def marg_prior(tree, device="cuda"):
    """The estimator's marginalization prior (``SlidingWindowEstimator.
    marg_prior``): H0, Jte0, c0, its linearization point x0, valid."""
    return _tree(MargPrior, tree, device)
