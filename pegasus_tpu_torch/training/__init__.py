"""3DGS asset training: losses, the fixed-capacity trainer, checkpoints."""

from pegasus_tpu_torch.training.trainer import GSTrainer, TrainConfig, TrainState
