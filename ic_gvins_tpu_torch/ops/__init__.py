from . import clahe, lk, subpix  # noqa: F401
