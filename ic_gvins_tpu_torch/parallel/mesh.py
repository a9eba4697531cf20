"""Batches of independent estimation problems over a list of devices.

Port of ``ic_gvins_tpu/parallel/mesh.py``. The JAX package shards a leading
batch axis of independent problems (windows, camera streams, IMU series)
over a 1-D device mesh and vmaps the one-problem programs over it. Here a
mesh is a list of torch devices. ``place`` splits the leading axis of every
leaf evenly over them, as a copy onto each device, and ``fn`` runs each
shard on its own device through the batched forms of the port: the
two-pass LM (``lm.solve_two_pass_batched``), the marginalization
(``over_problems``), the INS (``preintegrate_batch`` and ``mechanize_scan``
with a world axis) and the frontend frame, whose three kernels launch once
for all of a shard's worlds. ``fn`` returns one result per shard, in mesh
order, and ``gather`` concatenates them (``stack`` makes a batch of
one-problem trees). There are no collectives: the problems are
independent.

On one H100 the mesh is one device and one shard holds the whole batch;
``make_mesh(["cpu"] * 8)`` exercises the shard bookkeeping on the CPU.
"""

import torch

from ..solver import lm
from ..solver.problem import WindowConfig, over_problems


class Shards(tuple):
    """One leaf placed on a mesh: its pieces along the leading axis, one
    per device, in mesh order."""


def tree_map(fn, *trees):
    """``fn`` over the leaves (tensors, Shards) of NamedTuple / tuple /
    list trees of one structure; other values pass through from the
    first tree."""
    t = trees[0]
    if isinstance(t, (torch.Tensor, Shards)):
        return fn(*trees)
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*[tree_map(fn, *parts) for parts in zip(*trees)])
    if isinstance(t, (tuple, list)):
        return type(t)(tree_map(fn, *parts) for parts in zip(*trees))
    return t


def stack(trees):
    """One-problem trees stacked along a new leading (batch) axis."""
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def make_mesh(devices=None, axis="seq"):
    """The devices of the batch axis (``axis`` names it, as in the JAX
    signature; a list has that one axis): every CUDA device by default,
    and a RuntimeError when there is none. ``devices`` may name any torch
    devices, e.g. ``["cpu"] * 8``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices (e.g. ['cpu'] * 8) to run on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def _placer(mesh):
    def place(tree):
        """Every tensor leaf of ``tree`` split evenly along its leading axis
        over the mesh, each piece copied onto its device (Shards)."""
        def split(a):
            if a.shape[0] % len(mesh):
                raise ValueError(f"place: leading axis {a.shape[0]} does not split over {len(mesh)} devices")
            k = a.shape[0] // len(mesh)
            return Shards(a[i * k:(i + 1) * k].to(dev, copy=True) for i, dev in enumerate(mesh))
        return tree_map(split, tree)
    return place


def _on_shards(mesh, step):
    def run(*args):
        """``step`` on each device's shard of the placed ``args``; returns
        the per-shard results in mesh order."""
        return [step(*tree_map(lambda s: s[i] if isinstance(s, Shards) else s, args))
                for i in range(len(mesh))]
    return run


def gather(results, device=None):
    """The per-shard results of a sharded ``fn`` concatenated along the
    leading axis, on ``device`` (default: the first shard's device)."""
    def cat(*leaves):
        dev = leaves[0].device if device is None else device
        return torch.cat([leaf.to(dev) for leaf in leaves])
    return tree_map(cat, *results)


def batched_two_pass(cfg: WindowConfig, num_iterations: int):
    """The two-pass solve over a leading batch axis of problems: ``step(
    params_b, tables_b) -> (params_b, tables_b)``."""

    def step(params_b, tables_b):
        out_params, out_tables, _ = lm.solve_two_pass_batched(params_b, tables_b, cfg, num_iterations)
        return out_params, out_tables

    return step


def sharded_two_pass(mesh, cfg: WindowConfig, num_iterations: int, axis="seq"):
    """(fn, place): the batched two-pass solve, each device solving its
    shard's windows entirely locally."""
    return _on_shards(mesh, batched_two_pass(cfg, num_iterations)), _placer(mesh)


def frontend_frame_fn(shape, levels=4, block=(2, 2, 4), min_distance=5, ransac_thr=1.5):
    """One COMPLETE frontend frame (CLAHE + pyramid x2 + bidirectional LK +
    fundamental RANSAC + occupancy mask + blockwise Shi-Tomasi + subpixel)
    as a function of (img_prev, img_cur, pts, valid), the device side of
    Tracker.track without the host bookkeeping. It takes one world or a
    leading world axis of them; with the axis every stage runs all worlds
    at once and each kernel launches once (CLAHE once per image set)."""
    H, W = shape
    br, bc, pb = block

    from ..vision import features, lk as lkm, pyramid, ransac

    def frame(img_prev, img_cur, pts, valid):
        pyr_p = pyramid.build_pyramid(pyramid.clahe(img_prev), levels)
        pyr_c = pyramid.build_pyramid(pyramid.clahe(img_cur), levels)
        nxt, ok = lkm.track_bidirectional(pyr_p, pyr_c, pts, pts, valid, levels=levels)
        inl, _ = ransac.fundamental_ransac(pts.double(), nxt.double(), ok.double(), ransac_thr)
        ok = ok & inl
        mask = features.occupancy_mask(nxt, ok.float(), (H, W), min_distance)
        counts = torch.zeros(img_cur.shape[:-2] + (br * bc,), dtype=torch.int32, device=img_cur.device)
        corners, _resp, cvalid = features.detect_blockwise(
            pyr_c[0], mask, counts, block_rows=br, block_cols=bc, per_block=pb,
            min_distance=min_distance)
        corners = features.corner_subpix(pyr_c[0], corners.float(), cvalid)
        return nxt, ok, corners, cvalid

    return frame


def sharded_frontend(mesh, shape, axis="seq", **kw):
    """(fn, place): the full frontend frame over a leading world axis, each
    device tracking its shard's camera streams end to end."""
    return _on_shards(mesh, frontend_frame_fn(shape, **kw)), _placer(mesh)


def sharded_marg_step(mesh, cfg: WindowConfig, axis="seq"):
    """(fn, place): one full marginalization event (factor selection +
    structured Schur + prior shift, the estimator's marginalize) per
    problem, over a leading axis of problems."""
    from ..factors import marginalization as marg

    def one(params, tables):
        mt, mask, _lm_m = marg.select_marg_factors(tables, cfg, 1, 0)
        return marg.shift_prior(marg.marginalize(params, mt, mask, cfg), cfg, 1)

    return _on_shards(mesh, over_problems(one)), _placer(mesh)


def sharded_ins_step(mesh, int_params, with_earth=True, axis="seq"):
    """(fn, place): per-world INS work, one preintegration of the whole
    series and one mechanization of it, over a leading world axis:
    ``fn(imu, state, gravity, iewn)`` with each world's own gravity and
    earth rate for the mechanization (the preintegration takes gravity
    from ``int_params`` and no earth rate, as the JAX form)."""
    from ..ins import mechanization as mech
    from ..ins import preintegration as pre

    def step(imu, st, gravity, iewn):
        params = type(int_params)(*[a.to(imu.dt.device) for a in int_params])
        summ = pre.preintegrate_batch(params, imu, st, with_earth=with_earth)
        out, _ = mech.mechanize_scan(mech.MechConfig(gravity=gravity, iewn=iewn, iswithearth=with_earth), st, imu)
        return summ, out

    return _on_shards(mesh, step), _placer(mesh)
