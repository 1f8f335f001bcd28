from .model import Model, params_from_jax  # noqa: F401
from .types import ArchConfig, get_config, list_configs, register  # noqa: F401
