"""Offline visualization: tracking overlays + trajectory/map artifacts.

Replaces the reference's Drawer/DrawerRviz stack (tracking/drawer.{h,cc},
ROS/drawer_rviz.{h,cc}): instead of live RViz topics, the replay engine
renders the same artifacts offline — tracking images with flow lines and
per-type colored markers (drawer.cc:25-69), and the pose/path/point-cloud
channels become a trajectory+map figure written at the end of the run.

A carried-over copy of ``ic_gvins_tpu/vision/drawer.py`` (pure numpy; PIL
and matplotlib are imported inside the methods that draw, so the module
imports where they are absent).
"""

import os

import numpy as np

# marker colors by landmark type (drawer.cc uses blue/green/red circles)
_TYPE_COLORS = {
    0: (64, 128, 255),   # TRIANGULATED
    1: (64, 255, 64),    # DEPTH_ASSOCIATED
    2: (255, 192, 64),   # DEPTH_INITIALIZED
    3: (255, 64, 64),    # FIXED
}


class OfflineDrawer:
    """Collects frames/map snapshots and writes image/plot artifacts."""

    def __init__(self, outdir, draw_every=10, enabled=True):
        self.outdir = outdir
        self.enabled = enabled
        self.draw_every = max(int(draw_every), 1)
        self._count = 0
        self.fixed_points = []
        if enabled:
            os.makedirs(os.path.join(outdir, "tracking"), exist_ok=True)

    def update_frame(self, image, tracked_prev, tracked_cur, types, ref_prev=(), ref_cur=()):
        """Render one tracking overlay (Drawer::drawTrackingImage):
        per-landmark flow lines + type-colored squares, reference-track
        points in white."""
        if not self.enabled:
            return
        self._count += 1
        if (self._count - 1) % self.draw_every:
            return
        from PIL import Image, ImageDraw

        img = Image.fromarray(np.asarray(image).astype(np.uint8)).convert("RGB")
        d = ImageDraw.Draw(img)
        for p0, p1, tp in zip(tracked_prev, tracked_cur, types):
            c = _TYPE_COLORS.get(int(tp), (255, 255, 255))
            d.line([tuple(p0), tuple(p1)], fill=(255, 255, 0), width=1)
            x, y = p1
            d.rectangle([x - 3, y - 3, x + 3, y + 3], outline=c, width=1)
        for p0, p1 in zip(ref_prev, ref_cur):
            d.line([tuple(p0), tuple(p1)], fill=(128, 128, 128), width=1)
            x, y = p1
            d.ellipse([x - 2, y - 2, x + 2, y + 2], outline=(255, 255, 255))
        img.save(os.path.join(self.outdir, "tracking", f"frame_{self._count:06d}.png"))

    def add_fixed_mappoint(self, pw):
        """addNewFixedMappoint equivalent: marginalized landmark cloud."""
        self.fixed_points.append(np.asarray(pw))

    def finalize(self, trajectory):
        """Write the path + landmark-cloud figure (the RViz 'path'/'fixed'
        channels as an offline artifact)."""
        if not self.enabled:
            return
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 8))
        traj = np.asarray(trajectory)
        if len(traj):
            ax.plot(traj[:, 2], traj[:, 1], "b-", lw=1, label="trajectory")
        if self.fixed_points:
            pts = np.stack(self.fixed_points)
            ax.scatter(pts[:, 1], pts[:, 0], s=2, c="r", alpha=0.4, label="landmarks")
        ax.set_xlabel("East [m]")
        ax.set_ylabel("North [m]")
        ax.axis("equal")
        ax.legend()
        ax.grid(True, alpha=0.3)
        fig.savefig(os.path.join(self.outdir, "path.png"), dpi=120)
        plt.close(fig)
