from repro_torch.configs.base import (ARCH_IDS, ArchConfig, MoEConfig,
                                     SSMConfig, get_arch)

__all__ = ["ARCH_IDS", "ArchConfig", "MoEConfig", "SSMConfig", "get_arch"]
