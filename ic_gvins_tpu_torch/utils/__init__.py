from . import logger, timecost  # noqa: F401
