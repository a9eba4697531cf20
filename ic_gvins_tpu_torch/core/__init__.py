from . import rotation_np  # noqa: F401
