"""Dataset loading: native C++ parser with a numpy fallback.

A carried-over copy of ``ic_gvins_tpu/io/dataset.py`` (importing that
package imports jax). One deliberate difference (ROADMAP P5): the reference
reads the name column of ``frames.txt`` only when column 0 fails to parse,
so the ``stamp relpath`` lines that ``scripts/convert_kaist.py`` writes lose
their names; here ``load_frame_index`` returns the names whenever a line has
a second field, whichever parser read the stamps.

The replay engine consumes:
  imu_data:  dict(time, dt, dtheta (N,3), dvel (N,3)[, odovel])
  gnss_data: dict(time, blh (K,3) [rad,rad,m], std (K,3), yaw, isyawvalid)
  frames:    (times (F,), image_provider(k) -> (H,W) grayscale)

The C++ loader (native/loader.cpp) does the text parsing + IMU gap-filling;
build it with `make -C native`. When the shared library is absent
everything falls back to numpy (same semantics, slower). ``parser()`` says
which one runs.
"""

import ctypes
import os

import numpy as np

_LIB = None


def _find_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.path.join(here, "native", "libicgvins_loader.so")
    if os.path.exists(path):
        lib = ctypes.CDLL(path)
        for name in ("loader_load_imu", "loader_load_gnss", "loader_load_table"):
            getattr(lib, name).restype = ctypes.c_int
        lib.loader_free.restype = None
        _LIB = lib
    else:
        _LIB = False
    return _LIB


def parser():
    """'native' when the C++ loader is in use, else 'numpy'."""
    return "native" if _find_lib() else "numpy"


def _call_loader(fn, *args):
    out = ctypes.POINTER(ctypes.c_double)()
    rows = ctypes.c_long()
    cols = ctypes.c_long()
    rc = fn(*args, ctypes.byref(out), ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        raise IOError(f"native loader failed rc={rc}")
    arr = np.ctypeslib.as_array(out, shape=(rows.value, cols.value)).copy()
    _find_lib().loader_free(out)
    return arr


def load_imu(path, rate, mode="increment"):
    """IMU text log -> replay dict. Columns: time gx gy gz ax ay az [odovel].

    mode 'increment': samples already integrated over dt (reference/KAIST
    convention); 'rate': rad/s + m/s^2 converted by dt. Gap-fills lost
    samples at the nominal rate (ic_gvins.cc:171-183)."""
    m = 0 if mode == "increment" else 1
    lib = _find_lib()
    if lib:
        arr = _call_loader(lib.loader_load_imu, path.encode(), ctypes.c_double(rate), m)
    else:
        arr = _numpy_imu(path, rate, m)
    out = dict(time=arr[:, 0], dt=arr[:, 1], dtheta=arr[:, 2:5], dvel=arr[:, 5:8])
    if arr.shape[1] > 8:
        out["odovel"] = arr[:, 8]
    return out


def _numpy_imu(path, rate, mode):
    raw = np.loadtxt(path)
    if raw.ndim == 1:
        raw = raw[None]
    nominal_dt = 1.0 / rate
    rows = []
    prev = raw[0, 0] - nominal_dt
    has_odo = raw.shape[1] >= 8
    for r in raw:
        t = r[0]
        dt = t - prev
        if dt <= 0:
            continue
        fill = int(round(dt / nominal_dt)) - 1 if dt > nominal_dt * 1.5 else 0
        sdt = nominal_dt if fill else dt
        dth = r[1:4] * sdt if mode == 1 else r[1:4]
        dvl = r[4:7] * sdt if mode == 1 else r[4:7]
        odo = r[7] if has_odo else 0.0
        for g in range(fill):
            tg = t - dt + nominal_dt * (g + 1)
            rows.append([tg, nominal_dt, *dth, *dvl] + ([odo] if has_odo else []))
        rows.append([t, nominal_dt if fill else dt, *dth, *dvl] + ([odo] if has_odo else []))
        prev = t
    return np.asarray(rows)


def load_gnss(path):
    """GNSS text log -> replay dict. Columns: time lat(deg) lon(deg) h std x3
    [yaw(deg) yawvalid]: the two optional trailing columns carry a
    dual-antenna heading (GNSS::isyawvalid/yaw, common/types.h:32-40; the
    reference ROS ingest hard-disables it, fusion_ros.cc:179)."""
    lib = _find_lib()
    raw = None
    if lib:
        arr = _call_loader(lib.loader_load_gnss, path.encode())
    else:
        raw = np.loadtxt(path)
        if raw.ndim == 1:
            raw = raw[None]
        arr = raw[:, :7].copy()
        arr[:, 1:3] = np.deg2rad(arr[:, 1:3])
    out = dict(time=arr[:, 0], blh=arr[:, 1:4], std=arr[:, 4:7])
    out["yaw"] = np.zeros(len(arr))
    out["isyawvalid"] = np.zeros(len(arr), bool)
    if raw is None and lib:
        try:
            raw = np.loadtxt(path)
            if raw.ndim == 1:
                raw = raw[None]
        except ValueError:
            raw = None
    if raw is not None and raw.shape[1] >= 9:
        # align by TIMESTAMP, not row position: the native loader may skip
        # malformed rows, and positional indexing would then attach headings
        # to the wrong fixes
        j = np.searchsorted(raw[:, 0], arr[:, 0])
        j = np.clip(j, 0, len(raw) - 1)
        matched = np.abs(raw[j, 0] - arr[:, 0]) < 1e-6
        out["yaw"] = np.where(matched, np.deg2rad(raw[j, 7]), 0.0)
        out["isyawvalid"] = matched & (raw[j, 8] != 0)
    return out


def _frame_lines(path):
    """The (stamp, name or None) pairs of the data lines of ``path``: blank
    lines and lines starting with '#' or '%' (the native parser's comments)
    are skipped."""
    pairs = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts and not parts[0].startswith(("#", "%")):
                pairs.append((parts[0], parts[1] if len(parts) > 1 else None))
    return pairs


def load_frame_index(path, image_dir=None, suffix=".png"):
    """Frame timestamp list (one stamp per line, optionally 'stamp filename').

    Returns (times, image_provider) where image_provider(k) loads the frame
    as a float grayscale array via PIL. The names are read whenever a line
    has a second field (ROADMAP P5); a line without one names its frame
    ``f"{stamp:.6f}{suffix}"``."""
    lib = _find_lib()
    try:
        if lib:
            times = _call_loader(lib.loader_load_table, path.encode())[:, 0]
        else:
            times = np.atleast_1d(np.loadtxt(path, usecols=0))
    except (IOError, ValueError):
        times = None
    pairs = _frame_lines(path)
    if times is None:
        times = np.asarray([float(s) for s, _ in pairs])
    names = [n for _, n in pairs] if any(n is not None for _, n in pairs) else None
    if names is not None and len(names) != len(times):
        raise ValueError(f"{path}: {len(times)} stamps parsed but {len(names)} data lines")

    def image_provider(k):
        from PIL import Image

        if names is not None and names[k]:
            fname = names[k]
        else:
            fname = f"{times[k]:.6f}{suffix}"
        with Image.open(os.path.join(image_dir or os.path.dirname(path), fname)) as img:
            return np.asarray(img.convert("L"), np.float64)

    return np.asarray(times), image_provider
