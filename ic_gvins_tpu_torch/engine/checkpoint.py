"""Checkpoint/resume of the sliding-window estimator state.

Port of ``ic_gvins_tpu/engine/checkpoint.py``: one npz file holding node
states and times, GNSS entries, IMU segments, preintegration summaries, the
marginalization prior and the extrinsics, under the JAX package's keys.
Tree-valued state is stored leaf by leaf as ``{prefix}{i}``, numbered as
``jax.tree_util.tree_flatten`` numbers them (NamedTuple fields in order,
nested depth-first, ``None`` dropped), so a checkpoint written by either
package loads in the other. Restoring reproduces the estimator bit for bit.

The device prior crosses to the host through ``host.fetch`` (a copy) and
back with ``host.upload`` (``torch.tensor``, a copy onto ``est.device``);
the host mirrors come back as writable numpy arrays.
"""

import numpy as np

from ..solver.problem import MargPrior
from .estimator import GnssEntry, SlidingWindowEstimator
from .host import fetch, upload

_PRIOR_KEYS = ("pose_prior", "pose_prior_std", "mix_prior", "mix_prior_std")


def _leaves(tree):
    """The leaves of a NamedTuple tree in tree_flatten order."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [leaf for part in tree for leaf in _leaves(part)]
    return [tree]


def _rebuild(template, leaves):
    """A tree shaped like ``template`` from its leaves in tree_flatten order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, tuple):
            return type(t)(*[build(part) for part in t])
        return next(it)

    return build(template)


def _flatten_tree(prefix, leaves, out):
    for i, leaf in enumerate(leaves):
        out[f"{prefix}{i}"] = np.asarray(leaf)


def _host_mirror(prefix, template, data):
    """Writable numpy leaves of ``data[prefix*]`` in the dtypes of the
    host-mirror ``template``."""
    return _rebuild(template, [np.array(data[f"{prefix}{i}"], dtype=np.asarray(leaf).dtype)
                               for i, leaf in enumerate(_leaves(template))])


def save_checkpoint(path, est: SlidingWindowEstimator, extra=None):
    out = dict(
        n_nodes=np.asarray(est.n_nodes),
        times=est.times,
        poses=est.poses,
        mixes=est.mixes,
        ext=est.ext,
        td=np.asarray(est.td),
        gnss=np.asarray([[e.time, *e.blh, *e.std] for e in est.gnss_entries], np.float64).reshape(-1, 7),
        has_prior_cfg=np.asarray(1 if est.prior_cfg is not None else 0),
        has_marg=np.asarray(1 if est.marg_prior is not None else 0),
    )
    if est.prior_cfg is not None:
        for k, v in est.prior_cfg.items():
            out[f"prior_{k}"] = np.asarray(v)
    _flatten_tree("preint_", _leaves(est.preint_table), out)
    _flatten_tree("segs_", _leaves(est.seg_store), out)
    if est.marg_prior is not None:
        _flatten_tree("marg_", fetch(*_leaves(est.marg_prior)), out)
    # the JAX package's `segments_np[k] is not None`: slot k holds an interval
    out["seg_valid"] = np.asarray([1 if est.segment_samples(k) is not None else 0 for k in range(est.wcfg.P)])
    if extra:
        for k, v in extra.items():
            out[f"extra_{k}"] = np.asarray(v)
    np.savez_compressed(path, **out)


def load_checkpoint(path, est: SlidingWindowEstimator):
    """Restore a checkpoint into an estimator constructed with the SAME
    WindowConfig/params. Returns the dict of ``extra_`` entries."""
    data = np.load(path)
    est.n_nodes = int(data["n_nodes"])
    est.times = data["times"].copy()
    est.poses = data["poses"].copy()
    est.mixes = data["mixes"].copy()
    est.ext = data["ext"].copy()
    est.td = float(data["td"])
    est.gnss_entries = [GnssEntry(r[0], r[1:4], r[4:7]) for r in data["gnss"]]
    # interval tables are writable numpy host mirrors (see estimator); the
    # port keeps no segment list beside them: segment_samples reads the
    # restored table, which is what `seg_valid` records
    est.preint_table = _host_mirror("preint_", est.preint_table, data)
    est.seg_store = _host_mirror("segs_", est.seg_store, data)
    if int(data["has_marg"]):
        template = MargPrior.empty(est.wcfg)
        est.marg_prior = _rebuild(template, upload(
            [data[f"marg_{i}"] for i in range(len(_leaves(template)))], est.device))
    else:
        est.marg_prior = None
    if int(data["has_prior_cfg"]):
        est.prior_cfg = {k: data[f"prior_{k}"].copy() for k in _PRIOR_KEYS}
    else:
        est.prior_cfg = None
    return {k[6:]: data[k] for k in data.files if k.startswith("extra_")}
