"""Training layer of the port: the train step with gradient accumulation,
the AdamW optimizer and its freeze regimes, the Whisper objective,
checkpoints and the runner."""

from avsl_tpu_torch.train.loop import TrainState, make_eval_step, make_train_step
from avsl_tpu_torch.train.objectives import flamingo_loss_fn
from avsl_tpu_torch.train.optim import ClippedAdamW, select_optimizer, whisper_optimizer
from avsl_tpu_torch.train.runner import TrainerRunner

__all__ = [
    "ClippedAdamW",
    "TrainState",
    "TrainerRunner",
    "flamingo_loss_fn",
    "make_eval_step",
    "make_train_step",
    "select_optimizer",
    "whisper_optimizer",
]
