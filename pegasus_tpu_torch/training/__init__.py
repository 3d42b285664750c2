"""3DGS asset training: losses, the fixed-capacity trainer, checkpoints."""
