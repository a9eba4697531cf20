"""GPS <-> Unix time conversion (18 leap seconds).

A carried-over copy of ``ic_gvins_tpu/core/gpstime.py`` (parity with
IC-GVINS ``common/gpstime.h:28-43``). Pure-python floats (host-side
bookkeeping).
"""

SECS_PER_WEEK = 604800.0
GPS_UNIX_EPOCH_OFFSET = 315964800.0  # 1980-01-06 00:00:00 UTC in unix time
LEAP_SECONDS = 18.0


def unix2gps(unixs):
    """Unix seconds -> (gps week, seconds of week)."""
    gpss = unixs - GPS_UNIX_EPOCH_OFFSET + LEAP_SECONDS
    week = int(gpss // SECS_PER_WEEK)
    sow = gpss - week * SECS_PER_WEEK
    return week, sow


def gps2unix(week, sow):
    return week * SECS_PER_WEEK + sow + GPS_UNIX_EPOCH_OFFSET - LEAP_SECONDS


def unix2sow(unixs):
    """Unix seconds -> seconds-of-week timestamp used throughout the engine
    (fusion_ros.cc:127-130 converts incoming stamps the same way)."""
    _, sow = unix2gps(unixs)
    return sow
