"""Training layer of the port: the train step with gradient accumulation,
the AdamW optimizer and its freeze regimes (LoRA's too), the Whisper,
AV-HuBERT (fine-tuning and masked-cluster pretraining) and Auto-AVSR
objectives, checkpoints, the runner with parameter EMA, checkpoint
averaging, draft distillation and pipeline-parallel training."""

from avsl_tpu_torch.train.loop import TrainState, make_eval_step, make_train_step
from avsl_tpu_torch.train.objectives import (
    auto_avsr_loss_fn,
    avhubert_ctc_loss_fn,
    avhubert_pretrain_loss_fn,
    avhubert_seq2seq_loss_fn,
    flamingo_loss_fn,
)
from avsl_tpu_torch.train.optim import (
    ClippedAdamW,
    MultiSteps,
    constant_adamw,
    lora_optimizer,
    select_optimizer,
    whisper_optimizer,
)
from avsl_tpu_torch.train.pp import (
    shard_pp_state,
    split_whisper_encoder_params,
    whisper_encoder_pp_forward,
)
from avsl_tpu_torch.train.runner import TrainerRunner

__all__ = [
    "ClippedAdamW",
    "MultiSteps",
    "TrainState",
    "TrainerRunner",
    "auto_avsr_loss_fn",
    "avhubert_ctc_loss_fn",
    "avhubert_pretrain_loss_fn",
    "avhubert_seq2seq_loss_fn",
    "constant_adamw",
    "flamingo_loss_fn",
    "lora_optimizer",
    "make_eval_step",
    "make_train_step",
    "select_optimizer",
    "shard_pp_state",
    "split_whisper_encoder_params",
    "whisper_encoder_pp_forward",
    "whisper_optimizer",
]
