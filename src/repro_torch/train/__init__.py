from .zaal import TrainConfig, train  # noqa: F401
