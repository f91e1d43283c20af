"""TrainEngine (counterpart of paddle_tpu/training/engine.py).

One global batch per `step()`: forward and backward through the model's
kernels (every RMSNorm, attention and the loss run their fused kernels
on the card, forward and backward), one optimizer update, and no host
sync. The contract is the JAX engine's; its jit machinery (the compiled
fused step, buffer donation, retrace counters, AOT hooks, cost and
telemetry gauges) has no counterpart here, since PyTorch runs eagerly.

  - `step(inputs, labels=())` returns None until `log_window` steps are
    in, then the window's logs; the losses stay on the device until
    `sync()` reads the whole window with ONE host transfer and returns
    {'loss', 'loss_mean', 'window'} and the window's per-step 'losses'.
  - `accum_steps=k` splits the global batch into k equal microbatches
    (an indivisible batch raises), sums their gradients in float32
    buffers and applies ONE update with the mean: the JAX engine's
    `lax.scan` accumulation, so k is a memory knob.
  - `loss_fn=None` trains on `model.loss(*inputs, *labels)` (the Llama
    pretrain shape); otherwise on hapi's `loss_fn(model(*inputs),
    *labels)`.
  - `prefetch(iterator)` stages host batches on the card ahead of use
    through pinned memory and non-blocking copies.

Not ported (each raises NotImplementedError): a device `mesh`, an fp16
loss `scaler` (bf16 training needs none), hapi `metrics`.
"""
from __future__ import annotations

import collections

import numpy as np
import torch


def _to_tuple(x):
    if x is None:
        return ()
    return tuple(x) if isinstance(x, (list, tuple)) else (x,)


def _map_tensors(fn, batch):
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map_tensors(fn, b) for b in batch)
    return fn(batch)


class TrainEngine:
    """Owns the training and eval loop for one (model, optimizer, loss).

        eng = TrainEngine(model, AdamW(learning_rate=1e-4), log_window=10)
        for (ids,) in eng.prefetch(loader):
            logs = eng.step((ids,))       # None until the window closes
        logs = eng.sync()                 # flush the tail
    """

    def __init__(self, model, optimizer=None, loss_fn=None, *,
                 accum_steps=1, scaler=None, metrics=(), log_window=10,
                 mesh=None):
        for value, what in ((mesh, 'a device mesh (sharded training)'),
                            (scaler, 'fp16 loss scaling (bf16 training '
                                     'needs no scaler)'),
                            (metrics, 'hapi metrics')):
            if value:
                raise NotImplementedError(f'TrainEngine: {what} is not '
                                          f'ported yet')
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.accum_steps = int(accum_steps)
        if self.accum_steps < 1:
            raise ValueError(
                f'accum_steps must be >= 1, got {self.accum_steps}')
        self.log_window = max(1, int(log_window))
        if optimizer is not None and optimizer.state is None:
            optimizer.init(model)
        self._pending = []         # the open window's losses, on device
        self._eval_pending = []
        self._last_vals = None

    def _device(self):
        return next(self.model.parameters()).device

    def _compute_loss(self, inputs, labels):
        if self.loss_fn is None:
            return self.model.loss(*inputs, *labels)
        return self.loss_fn(self.model(*inputs), *labels)

    def _on_device(self, xs):
        dev = self._device()
        return tuple(torch.as_tensor(x).to(dev) for x in _to_tuple(xs))

    # -- the hot path ------------------------------------------------------

    def step(self, inputs, labels=()):
        """One update from one global batch. Returns the window's logs
        when this step closes a log window (one host transfer), else
        None."""
        if self.optimizer is None:
            raise RuntimeError('TrainEngine built without an optimizer '
                               'is eval-only; pass one to train')
        inputs, labels = self._on_device(inputs), self._on_device(labels)
        k = self.accum_steps
        if k > 1:
            for a in inputs + labels:
                if a.shape[0] % k:
                    raise ValueError(f'global batch {a.shape[0]} not '
                                     f'divisible by accum_steps={k}')
        params = self.optimizer._params
        self.optimizer.clear_grad()
        if k == 1:
            loss = self._compute_loss(inputs, labels)
            loss.backward()
            grads = {n: p.grad for n, p in params.items()}
        else:
            # microbatch i holds rows [i * B/k, (i + 1) * B/k), as the JAX
            # engine's reshape to (k, B/k, ...) splits them
            micro = [tuple(a.reshape((k, a.shape[0] // k) + a.shape[1:])[i]
                           for a in inputs + labels) for i in range(k)]
            acc = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in params.items()}
            losses = []
            for mb in micro:
                mloss = self._compute_loss(mb[:len(inputs)],
                                           mb[len(inputs):])
                mloss.backward()
                with torch.no_grad():
                    for n, p in params.items():
                        if p.grad is not None:
                            acc[n].add_(p.grad)
                self.optimizer.clear_grad()
                losses.append(mloss.detach())
            grads = {n: a.div_(k) for n, a in acc.items()}
            loss = torch.stack(losses).mean()
        self.optimizer.apply_gradients(grads)
        self.optimizer.clear_grad()
        self._pending.append(loss.detach())
        if len(self._pending) >= self.log_window:
            return self.sync()
        return None

    def sync(self):
        """Close the window: one host transfer for every loss since the
        last sync. Returns {'loss' (the last), 'loss_mean', 'window',
        'losses' (each step's)}."""
        if not self._pending:
            return self._last_vals and dict(self._last_vals)
        pending, self._pending = self._pending, []
        vals = torch.stack([v.float() for v in pending]).cpu().tolist()
        self._last_vals = {'loss': vals[-1],
                           'loss_mean': float(np.mean(vals)),
                           'window': len(vals), 'losses': vals}
        return dict(self._last_vals)

    # -- eval --------------------------------------------------------------

    def eval_step(self, inputs, labels=()):
        """Buffer one eval batch's loss on the device; every
        `log_window` batches the window flushes through eval_sync()."""
        with torch.no_grad():
            loss = self._compute_loss(self._on_device(inputs),
                                      self._on_device(labels))
        self._eval_pending.append(loss.detach())
        if len(self._eval_pending) >= self.log_window:
            return self.eval_sync()
        return None

    def eval_sync(self):
        """One host transfer for the buffered eval window; the losses as
        floats."""
        if not self._eval_pending:
            return []
        pending, self._eval_pending = self._eval_pending, []
        return torch.stack([v.float() for v in pending]).cpu().tolist()

    # -- input side --------------------------------------------------------

    def prefetch(self, iterator, size=2):
        """Yield the batches of `iterator` (arrays or tensors, nested in
        tuples or lists) as tensors on the model's device, `size`
        batches ahead: each is copied from pinned host memory without
        blocking, so the copy overlaps the step in flight."""
        dev = self._device()

        def put(x):
            t = torch.as_tensor(x)
            if dev.type == 'cuda':
                t = t.pin_memory()
            return t.to(dev, non_blocking=True)

        staged = collections.deque()
        for batch in iterator:
            staged.append(_map_tensors(put, batch))
            if len(staged) > size:
                yield staged.popleft()
        while staged:
            yield staged.popleft()


__all__ = ['TrainEngine']
