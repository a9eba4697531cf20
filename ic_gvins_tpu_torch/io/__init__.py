from . import dataset  # noqa: F401
