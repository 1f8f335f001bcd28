from .model import Model, params_from_jax  # noqa: F401
from .types import (SHAPES, ArchConfig, ShapeSpec,  # noqa: F401
                    applicable_shapes, get_config, list_configs, register)
