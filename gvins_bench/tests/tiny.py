"""A cell small enough for the CPU: the kaist-urban38 deployment seen by a
320x140 camera (the same field of view), over a 24 s log, with a window of a
few frames. The program runs its plain PyTorch kernels on the CPU."""

import copy
import re
from pathlib import Path

SCALE = 0.25


def _set(yaml, key, value):
    return re.sub(rf"^(\s*{key}:).*$", rf"\1 {value}", yaml, count=1, flags=re.M)


def spec(tmp_path, seconds_world=24.0):
    from gvins_bench import run

    full = run.cell_spec("urban38.replay")
    cfg = copy.deepcopy(full["cfg"])
    cam = cfg["camera"]
    fx, fy, cx, cy = cam["intrinsic"]
    cam["resolution"] = [320, 140]
    cam["intrinsic"] = [fx * SCALE, fy * SCALE, (cx + 0.5) * SCALE - 0.5, (cy + 0.5) * SCALE - 0.5]
    yaml = full["yaml"].read_text()
    yaml = _set(yaml, "intrinsic", cam["intrinsic"])
    yaml = _set(yaml, "resolution", cam["resolution"])
    yaml = _set(yaml, "track_max_features", 120)
    yaml = _set(yaml, "landmark_slots", 256)
    yaml = _set(yaml, "reproj_slots", 1024)
    path = Path(tmp_path) / "tiny.yaml"
    path.write_text(yaml)
    traffic = copy.deepcopy(full["traffic"])
    traffic.update(world_s=seconds_world, warm_frames=3, profile_s=1.0, check_frames=[2, 5], check_samples=2,
                   check_nodes=[0, 3], check_episode=[0, 1])
    traffic["blob"].update(sigma_px=1.6, half_px=5)
    return dict(full, yaml=path, cfg=cfg, traffic=traffic)
