"""Concrete optimizers (counterpart of paddle_tpu/optimizer/optimizers.py):
each defines its float32 slots and a per-parameter update, in place."""
from __future__ import annotations

import torch

from .optimizer import Optimizer


def _zeros_like(params):
    return {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in params.items()}


class SGD(Optimizer):
    def update_param(self, p, g, slots, lr, step):
        return p.sub_(lr * g)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        self.momentum = momentum
        self.use_nesterov = use_nesterov
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def init_slots(self, params):
        return {'velocity': _zeros_like(params)}

    def update_param(self, p, g, slots, lr, step):
        v = slots['velocity'].mul_(self.momentum).add_(g)
        if self.use_nesterov:
            return p.sub_(lr * (g + self.momentum * v))
        return p.sub_(lr * v)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None):
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def init_slots(self, params):
        return {'m': _zeros_like(params), 'v': _zeros_like(params)}

    def update_param(self, p, g, slots, lr, step):
        b1, b2 = self.beta1, self.beta2
        m = slots['m'].mul_(b1).add_((1 - b1) * g)
        v = slots['v'].mul_(b2).add_((1 - b2) * g * g)
        mhat = m / (1 - b1 ** step)
        denom = (v / (1 - b2 ** step)).sqrt_().add_(self.epsilon)
        return p.sub_(lr * mhat / denom)


class AdamW(Adam):
    """Adam with decoupled weight decay. As in the JAX package,
    `apply_decay_param_fun` is stored and not read: every trainable
    parameter decays."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name=name)
        self._decoupled_decay = True
        self.apply_decay_param_fun = apply_decay_param_fun


__all__ = ['SGD', 'Adam', 'AdamW', 'Momentum']
