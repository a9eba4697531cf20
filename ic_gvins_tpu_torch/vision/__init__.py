from . import camera, pyramid, features, lk, ransac  # noqa: F401
