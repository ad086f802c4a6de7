from .base import (ArchConfig, MLAConfig, MoEConfig, SSMConfig, ShapeConfig,
                   SHAPES, all_archs, cells, get_arch)

__all__ = ["ArchConfig", "MLAConfig", "MoEConfig", "SSMConfig", "ShapeConfig",
           "SHAPES", "all_archs", "cells", "get_arch"]
