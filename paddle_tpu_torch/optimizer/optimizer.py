"""Optimizer base (counterpart of paddle_tpu/optimizer/optimizer.py).

The update follows the JAX package's math, not `torch.optim`'s:

- moment slots are float32, also for bf16 parameters;
- each parameter is updated in float32, from its `multi_precision`
  master copy or from the parameter cast up, and cast back to its dtype;
- `grad_clip` runs first, over the gradients as given;
- a float `weight_decay` is coupled L2 (`g + wd * p`) except where an
  optimizer decouples it (AdamW: `p - lr * wd * p` before the update),
  and it applies to every trainable parameter, norms included;
- the learning rate of update t (counted from 1) is `lr(t)` for a
  schedule.

Updates run in place under `torch.no_grad()`. The step counter lives on
the host, so an update reads nothing back from the device.

    opt = AdamW(learning_rate=1e-4, weight_decay=0.01)
    opt.init(model)                  # or AdamW(..., parameters=model)
    loss.backward()
    opt.step()                       # the .grad of every parameter
    opt.clear_grad()
"""
from __future__ import annotations

import torch

from .lr import LRScheduler


def _named_trainable(parameters):
    """{name: parameter} of a module's trainable parameters, or of an
    iterable of parameters (named by position)."""
    named = (parameters.named_parameters()
             if isinstance(parameters, torch.nn.Module)
             else ((str(i), p) for i, p in enumerate(parameters)))
    return {n: p for n, p in named if p.requires_grad}


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if weight_decay is not None and not isinstance(weight_decay,
                                                       (int, float)):
            raise NotImplementedError(
                'regularizer objects as weight_decay (L1Decay, L2Decay) are '
                'not ported yet; pass a float')
        self._lr = learning_rate
        self._weight_decay = 0.0 if weight_decay is None else \
            float(weight_decay)
        self._decoupled_decay = False
        self.grad_clip = grad_clip
        self.multi_precision = multi_precision
        self.state = None
        self._params = None
        if parameters is not None:
            self.init(parameters)

    # -- lr ---------------------------------------------------------------
    def get_lr(self, step=None):
        """The rate of update `step` (default: the next one)."""
        if step is None:
            step = (self.state['step'] if self.state else 0) + 1
        if isinstance(self._lr, LRScheduler):
            return float(self._lr(step))
        return float(self._lr)

    def set_lr(self, lr):
        self._lr = lr

    # -- state ------------------------------------------------------------
    def init(self, parameters):
        """Bind the trainable parameters of a module (or an iterable of
        parameters) and build zeroed slots. Returns the state."""
        self._params = _named_trainable(parameters)
        state = {'step': 0, 'slots': self.init_slots(self._params)}
        if self.multi_precision:
            state['master'] = {n: p.detach().float().clone()
                               for n, p in self._params.items()
                               if p.dtype == torch.bfloat16}
        self.state = state
        return state

    def init_slots(self, params):
        """{slot name: {parameter name: float32 tensor}}."""
        return {}

    def update_param(self, p, g, slots, lr, step):  # pragma: no cover
        """Update the float32 parameter `p` in place from the float32
        gradient `g` and this parameter's slots; return it."""
        raise NotImplementedError

    def state_dict(self):
        return self.state

    def set_state_dict(self, state):
        self.state = state

    # -- update -----------------------------------------------------------
    def apply_gradients(self, grads):
        """One update from `grads` ({parameter name: gradient}, any
        dtype; a missing or None gradient counts as zeros)."""
        if self.state is None:
            raise RuntimeError('optimizer has no parameters: call '
                               'init(model) or pass parameters=')
        with torch.no_grad():
            grads = {n: (grads.get(n) if grads.get(n) is not None
                         else torch.zeros_like(p))
                     for n, p in self._params.items()}
            if self.grad_clip is not None:
                grads = self.grad_clip(grads)
            step = self.state['step'] + 1
            lr = self.get_lr(step)
            wd = self._weight_decay
            master = self.state.get('master', {})
            slots = self.state['slots']
            for name, p in self._params.items():
                g = grads[name]
                if wd and not self._decoupled_decay:
                    g = g + wd * p.to(g.dtype)
                # float32 working copy: the master, or the parameter
                # itself when it is float32, or the parameter cast up
                cp = master.get(name)
                if cp is None:
                    cp = p.float()
                if wd and self._decoupled_decay:
                    cp.sub_(cp * (lr * wd))
                cp = self.update_param(
                    cp, g.float(), {k: s[name] for k, s in slots.items()},
                    lr, step)
                if cp is not p:
                    p.copy_(cp)
            self.state['step'] = step

    def step(self):
        """Update from the `.grad` of every bound parameter."""
        if self._params is None:
            raise RuntimeError('optimizer has no parameters: call '
                               'init(model) or pass parameters=')
        self.apply_gradients({n: p.grad for n, p in self._params.items()})

    def clear_grad(self):
        for p in (self._params or {}).values():
            p.grad = None
