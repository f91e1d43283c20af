"""Learning-rate schedules (counterpart of paddle_tpu/optimizer/lr.py).

Each schedule is a function of the optimizer's step count,
`sched(step) -> lr`, evaluated on the host from the counter the
optimizer keeps (the JAX package evaluates the same function on the
device inside its compiled step; no device value is read here either).
`.step()` / `.get_lr()` are the imperative shims of the JAX package.
"""
from __future__ import annotations

import math


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = learning_rate
        self.last_epoch = last_epoch
        self._host_step = 0

    def __call__(self, step):
        return self.get_lr_at(step)

    def get_lr_at(self, step):  # pragma: no cover - abstract
        raise NotImplementedError

    def step(self, epoch=None):
        self._host_step = self._host_step + 1 if epoch is None else epoch

    def get_lr(self):
        return float(self.get_lr_at(self._host_step))

    def state_dict(self):
        return {'host_step': self._host_step}

    def set_state_dict(self, state):
        self._host_step = int(state.get('host_step', 0))


class LinearWarmup(LRScheduler):
    """Linear ramp from `start_lr` to `end_lr` over `warmup_steps`, then
    `learning_rate` (a float, or a schedule started at the ramp's end)."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        super().__init__(end_lr, last_epoch, verbose)
        self.inner = (learning_rate if isinstance(learning_rate, LRScheduler)
                      else None)
        self.peak = None if self.inner is not None else learning_rate
        self.warmup_steps, self.start_lr, self.end_lr = (warmup_steps,
                                                         start_lr, end_lr)

    def get_lr_at(self, step):
        s = float(step)
        if s < self.warmup_steps:
            return self.start_lr + (self.end_lr - self.start_lr) * s \
                / self.warmup_steps
        if self.inner is not None:
            return self.inner(max(s - self.warmup_steps, 0.0))
        return self.peak


class CosineAnnealingDecay(LRScheduler):
    """Half a cosine from `learning_rate` down to `eta_min` over `T_max`
    steps, then `eta_min`."""

    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        super().__init__(learning_rate, last_epoch, verbose)
        self.T_max, self.eta_min = T_max, eta_min

    def get_lr_at(self, step):
        s = min(float(step), self.T_max)
        return self.eta_min + (self.base_lr - self.eta_min) * 0.5 * (
            1 + math.cos(math.pi * s / self.T_max))


__all__ = ['CosineAnnealingDecay', 'LRScheduler', 'LinearWarmup']
