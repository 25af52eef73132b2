from .pipeline import DataConfig, DataLoader, batch_specs

__all__ = ["DataConfig", "DataLoader", "batch_specs"]
