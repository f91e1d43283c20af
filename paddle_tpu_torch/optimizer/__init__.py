"""paddle_tpu_torch.optimizer (counterpart of paddle_tpu/optimizer):
the optimizers the training slice runs, their learning-rate schedules,
and the base class they share."""
from . import lr
from .optimizer import Optimizer
from .optimizers import SGD, Adam, AdamW, Momentum

__all__ = ['SGD', 'Adam', 'AdamW', 'Momentum', 'Optimizer', 'lr']
