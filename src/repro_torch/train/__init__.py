from repro_torch.train.optimizer import AdamWConfig  # noqa: F401
from repro_torch.train.trainer import (  # noqa: F401
    TrainConfig,
    Trainer,
    make_train_step,
)
