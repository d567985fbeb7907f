from repro_torch.configs.base import ArchConfig, get_config

__all__ = ["ArchConfig", "get_config"]
