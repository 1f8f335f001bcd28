from . import pendigits  # noqa: F401
