"""Asset registry (dataset layout and ids)."""
