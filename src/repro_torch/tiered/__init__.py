from repro_torch.tiered.store import TieredStore, TieredStoreConfig

__all__ = ["TieredStore", "TieredStoreConfig"]
