"""Training: the port of the JAX package's ``training/`` (the loss, the
optimizer with optax's semantics, the train state, the train and eval
steps (on CUDA the train step as a captured graph, ``capture.py``),
checkpoints in the JAX package's npz format, the resilience layer, the
loop and the evaluation harness, ``evaluate.py``); ``python -m
raft_tpu_torch.training`` runs it (``-m val`` evaluates)."""

from .capture import GraphedTrainStep
from .checkpoint import (latest_checkpoint, restore_checkpoint,
                         save_checkpoint)
from .loss import epe_metrics, sequence_loss
from .optim import make_optimizer, make_schedule, one_cycle_schedule
from .resilience import (PREEMPT_EXIT_CODE, CheckpointWriter,
                         PreemptionGuard, TrainingPreempted)
from .state import TrainState, split_bn_state
from .step import Batch, make_eval_step, make_train_step, make_warm_eval_step

__all__ = ["GraphedTrainStep", "latest_checkpoint", "restore_checkpoint", "save_checkpoint",
           "epe_metrics", "sequence_loss", "make_optimizer", "make_schedule",
           "one_cycle_schedule", "PREEMPT_EXIT_CODE", "CheckpointWriter",
           "PreemptionGuard", "TrainingPreempted", "TrainState",
           "split_bn_state", "Batch", "make_eval_step", "make_train_step",
           "make_warm_eval_step"]
