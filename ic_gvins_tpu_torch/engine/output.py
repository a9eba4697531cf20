"""Result-file writers with the reference schemas.

A carried-over copy of ``ic_gvins_tpu/engine/output.py``: gvins.nav
(IC-GVINS ``misc.cc:437-454``), IMU_ERR.bin (``misc.cc:456-482``, binary
doubles), trajectory.csv (TUM-style, ``misc.cc:484-498``), statistics.txt,
extrinsic.txt, mappoint.txt, tracking.txt; text columns as FileSaver::dump's
"%-15.9lf " (``fileio/filesaver.cc:51-66``). One change: the JAX copy
converts each nav sample with jax calls; here ``write_nav_chunk`` converts a
chunk of samples at once in numpy (``earth_np``, ``rotation_np``), so the
replay runs no device operation per sample; ``write_nav`` is that path
for one sample.
"""

import math
import os
import struct

import numpy as np

from ..core import earth_np, rotation_np

R2D = 180.0 / math.pi


class TextWriter:
    def __init__(self, path):
        self.f = open(path, "w")

    def dump(self, values):
        self.f.write(" ".join(f"{v:<15.9f}" for v in values).rstrip() + "\n")

    def flush(self):
        self.f.flush()

    def close(self):
        self.f.close()


class BinaryWriter:
    def __init__(self, path):
        self.f = open(path, "wb")

    def dump(self, values):
        self.f.write(struct.pack(f"<{len(values)}d", *values))

    def flush(self):
        self.f.flush()

    def close(self):
        self.f.close()


class OutputFiles:
    """The result-file set created by the GVINS ctor (ic_gvins.cc:62-67)."""

    def __init__(self, outdir):
        os.makedirs(outdir, exist_ok=True)
        self.outdir = outdir
        self.nav = TextWriter(os.path.join(outdir, "gvins.nav"))
        self.mappoint = TextWriter(os.path.join(outdir, "mappoint.txt"))
        self.statistics = TextWriter(os.path.join(outdir, "statistics.txt"))
        self.extrinsic = TextWriter(os.path.join(outdir, "extrinsic.txt"))
        self.imuerr = BinaryWriter(os.path.join(outdir, "IMU_ERR.bin"))
        self.trajectory = TextWriter(os.path.join(outdir, "trajectory.csv"))
        self.tracking = TextWriter(os.path.join(outdir, "tracking.txt"))
        self._nav_counter = 0

    def write_nav(self, origin, time, p, q_xyzw, v, bg, ba, sodo=0.0, decimate=10):
        """One IMU sample's nav/err/trajectory output at 1-in-``decimate``
        IMU rate (misc.cc:417-499): ``write_nav_chunk`` of that one sample,
        on the same counter."""
        self.write_nav_chunk(origin, np.array([time], np.float64), np.asarray(p)[None],
                             np.asarray(q_xyzw)[None], np.asarray(v)[None], bg, ba, sodo, decimate)

    def write_nav_chunk(self, origin, times, p, q_xyzw, v, bg, ba, sodo=0.0, decimate=10):
        """Nav/err/trajectory output of a chunk of IMU samples at 1-in-
        ``decimate`` IMU rate, the counter running across chunks
        (misc.cc:417-499). times (n,), p/v (n, 3), q (n, 4) in the local
        frame; origin = blh of the world origin for the global conversion."""
        n = len(times)
        sel = np.nonzero((self._nav_counter + np.arange(n)) % decimate == 0)[0]
        self._nav_counter += n
        if not len(sel):
            return
        p, q, v = np.asarray(p)[sel], np.asarray(q_xyzw)[sel], np.asarray(v)[sel]
        blh, Rg = earth_np.local2global_pose(origin, rotation_np.to_matrix(q), p)
        att = earth_np.matrix_to_euler(Rg) * R2D
        pos = blh.copy()
        pos[:, :2] *= R2D
        bg_out = np.asarray(bg) * R2D * 3600.0
        ba_out = np.asarray(ba) * 1e5
        for j, i in enumerate(sel):
            t = times[i]
            self.nav.dump([0, t, *pos[j], *v[j], *att[j]])
            self.imuerr.dump([t, *bg_out, *ba_out, sodo])
            self.trajectory.dump([t, *p[j], *q[j]])
        self.nav.flush()
        self.imuerr.flush()

    def write_statistics(self, row):
        self.statistics.dump(row)
        self.statistics.flush()

    def write_extrinsic(self, time, t_b_c, euler_deg, td):
        self.extrinsic.dump([time, *t_b_c, *euler_deg, td])
        self.extrinsic.flush()

    def write_mappoint(self, pw):
        self.mappoint.dump([pw[0], pw[1], pw[2]])

    def write_tracking(self, row):
        self.tracking.dump(row)
        self.tracking.flush()

    def close(self):
        for w in (self.nav, self.mappoint, self.statistics, self.extrinsic,
                  self.imuerr, self.trajectory, self.tracking):
            w.close()
