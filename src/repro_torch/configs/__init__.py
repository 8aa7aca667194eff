from repro_torch.configs.base import FedZOConfig

__all__ = ["FedZOConfig"]
