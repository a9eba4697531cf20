from . import config  # noqa: F401
