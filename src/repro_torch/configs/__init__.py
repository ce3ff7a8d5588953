from repro_torch.configs.base import (ARCH_IDS, SHAPES, ArchConfig, MoEConfig,
                                     ShapeConfig, SSMConfig, cell_applicable,
                                     get_arch)

__all__ = ["ARCH_IDS", "SHAPES", "ArchConfig", "MoEConfig", "ShapeConfig",
           "SSMConfig", "cell_applicable", "get_arch"]
