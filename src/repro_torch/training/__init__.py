"""Training substrate: AdamW, the microbatched trainer with checkpoint/
restart, gradient compression."""
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                           adamw_update)
from repro_torch.training.train_loop import TrainConfig, Trainer
__all__ = ["AdamWConfig", "TrainConfig", "Trainer", "adamw_init",
           "adamw_update"]
