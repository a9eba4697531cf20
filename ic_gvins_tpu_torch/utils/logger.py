"""Structured logging (the glog wrapper equivalent, common/logging.h:34-87).

A carried-over copy of ``ic_gvins_tpu/utils/logger.py``. LOGI/LOGW/LOGE map
to python logging with an optional run-directory file sink (FLAGS_log_dir
equivalent): ``ic_gvins_tpu.log`` in ``outdir``, the file name the
reference's runner writes."""

import logging
import os
import sys

_logger = logging.getLogger("ic_gvins_tpu_torch")


def initialize(outdir=None, level=logging.INFO, to_stderr=True):
    _logger.setLevel(level)
    for h in _logger.handlers:
        h.close()
    _logger.handlers = []
    fmt = logging.Formatter("%(levelname).1s %(asctime)s %(message)s", "%H:%M:%S")
    if to_stderr:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(fmt)
        _logger.addHandler(h)
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        h = logging.FileHandler(os.path.join(outdir, "ic_gvins_tpu.log"))
        h.setFormatter(fmt)
        _logger.addHandler(h)
    return _logger


def LOGI(*args):
    _logger.info(" ".join(str(a) for a in args))


def LOGW(*args):
    _logger.warning(" ".join(str(a) for a in args))


def LOGE(*args):
    _logger.error(" ".join(str(a) for a in args))
