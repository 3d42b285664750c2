"""Asset registry (dataset layout and ids)."""

from pegasus_tpu_torch.assets.registry import Asset, AssetRegistry
