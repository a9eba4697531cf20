#!/usr/bin/env python3
"""CLI replay entry point of the PyTorch port (``ic_gvins_tpu_torch``), the
counterpart of scripts/run_gvins.py (the main() / FusionROS::run equivalent,
ROS/fusion_ros.cc:52-121, 260-281): load gvins.yaml, load the dataset, run
the selected model, write the result files.

Usage:
  python scripts/run_gvins_torch.py --config gvins.yaml --imu imu.txt --gnss gnss.txt \\
      [--frames frames.txt --imagedir imgs/] [--model gvins|gins] \\
      [--imu-mode increment|rate] [--output outdir] [--device cuda|cpu]

The device defaults to the GPU (``cuda``); ``--device cpu`` runs the port's
plain PyTorch versions of the kernels on the CPU. Dataset formats
(ic_gvins_tpu_torch/io/dataset.py):
  imu.txt    time gx gy gz ax ay az [odovel]   (increment or rate form)
  gnss.txt   time lat(deg) lon(deg) h std_n std_e std_d [yaw(deg) yawvalid]
  frames.txt one stamp per line [optional filename column]
"""

import argparse
import datetime
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    """Run one replay from files; returns the model."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--imu", required=True)
    ap.add_argument("--gnss", required=True)
    ap.add_argument("--frames")
    ap.add_argument("--imagedir")
    ap.add_argument("--model", default="gvins", choices=["gvins", "gins"])
    ap.add_argument("--imu-mode", default="increment", choices=["increment", "rate"])
    ap.add_argument("--output")
    ap.add_argument("--device", default="cuda", help="torch device of the replay (default: cuda)")
    args = ap.parse_args(argv)

    from ic_gvins_tpu_torch.engine.config import load_config
    from ic_gvins_tpu_torch.io import dataset
    from ic_gvins_tpu_torch.utils import logger

    cfg = load_config(args.config)

    outdir = args.output or cfg.outputpath or "./gvins_output"
    if cfg.is_make_outputdir:
        stamp = datetime.datetime.now().strftime("%Y%m%d%H%M%S")
        outdir = os.path.join(outdir, stamp)
    os.makedirs(outdir, exist_ok=True)
    shutil.copy(args.config, os.path.join(outdir, "gvins.yaml"))
    log = logger.initialize(outdir)

    log.info(f"loading IMU {args.imu} ({dataset.parser()} parser)")
    imu = dataset.load_imu(args.imu, cfg.imudatarate, mode=args.imu_mode)
    log.info(f"loaded {len(imu['time'])} IMU samples")
    gnss = dataset.load_gnss(args.gnss)
    log.info(f"loaded {len(gnss['time'])} GNSS fixes")

    if args.model == "gins" or not args.frames:
        from ic_gvins_tpu_torch.models.gins import GinsModel

        model = GinsModel(cfg, outdir=outdir, device=args.device)
        traj = model.run(imu, gnss)
    else:
        from ic_gvins_tpu_torch.models.gvins import GvinsModel

        times, provider = dataset.load_frame_index(args.frames, args.imagedir)
        log.info(f"loaded {len(times)} frame stamps")
        model = GvinsModel(cfg, outdir=outdir, device=args.device)
        traj = model.run(imu, gnss, times, provider)

    log.info(f"replay finished: {len(traj)} trajectory nodes, state={model.state}")
    log.info(f"results in {outdir}")
    return model


if __name__ == "__main__":
    main()
