"""Mixture-of-Experts layer (counterpart of paddle_tpu/distributed/moe.py):
top-k gating, the GShard capacity dispatch and the dropless grouped
path, routed and shared SwiGLU experts.

Two dispatch forms compute the experts, as in the JAX package:

- dense (GShard): (tokens, E, capacity) one-hot dispatch and combine
  tensors, filled choice by choice; an expert past its capacity drops
  the routing. The expert product is a batched `torch.matmul` over
  (E, C, H) buckets, as XLA computes it there.
- ragged (dropless): the (token, choice) pairs sorted by expert, each
  expert's rows times its weights by the grouped product X1
  (`ops.moe_grouped_matmul`, in place of XLA's `ragged_dot`), the gate
  weights applied and the k choices of a token added back in a fixed
  order. On the card it reads nothing on the host, so the layer's
  dropless forward can be captured in a CUDA graph.

Both forms train: every step is differentiable (the router's float32
product, the top-k sort and renormalisation, the aux loss through
`probs.mean`, the gathers, gate scaling, inverse permutation and k-way
sum, the shared experts), and under a gradient the grouped product runs
`ops.moe_grouped_matmul`'s autograd Function, whose backward launches
X1's dx and dW kernels on the card (one launch each, the offsets on the
device) and their plain versions on the CPU. The dense form's einsums
and batched products differentiate as PyTorch's own.

The cached forward of `models.moe_lm` always routes dropless. Expert
weights are dense tensors: the `NaiveGate` / `SwitchGate` / `GShardGate`
classes, quantized expert weights (`QuantizedExpertWeight`, and with it
the JAX package's `_expert_einsum` / `_dense_expert` dispatch) and
expert parallelism are not ported (ROADMAP B7, B4, A5).
"""
from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F

from .. import ops


def _topk_gates(logits, k: int):
    """Softmax probabilities (float32), the top-k choice per token with
    its gate values renormalised over the k chosen, and the load-balance
    aux loss E * sum(frac_probs * frac_top1_tokens). Returns (probs,
    gate_vals (T, k), expert_idx (T, k) int64, aux_loss ()). Ties go to
    the lower expert index, as `jax.lax.top_k` orders them (a stable
    descending sort; `torch.topk` promises no order)."""
    E = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[:, :k], idx[:, :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    me = probs.mean(dim=0)
    experts = torch.arange(E, device=logits.device)
    ce = (expert_idx[:, :1] == experts).float().mean(dim=0)
    aux_loss = E * torch.sum(me * ce)
    return probs, gate_vals, expert_idx, aux_loss


def limit_by_capacity(topk_idx, num_expert, capacity):
    """Keep at most `capacity` routings per expert, in token order (the
    flattened (token, choice) order); dropped entries become -1."""
    flat = topk_idx.reshape(-1).long()
    oh = (flat[:, None] == torch.arange(num_expert, device=flat.device)
          ).long()
    pos = torch.cumsum(oh, dim=0) - oh
    slot = (pos * oh).sum(-1)
    keep = slot < capacity
    return torch.where(keep, flat, torch.full_like(flat, -1)).reshape(
        topk_idx.shape)


def top_k_gating(logits, k: int, capacity: int):
    """GShard top-k gating with capacity over logits (T, E): (dispatch
    (T, E, C) float32 0/1, combine (T, E, C) float32 gate weights,
    aux_loss). Each choice pass places its tokens after the slots the
    earlier passes filled (`fill`); a slot at or past `capacity` drops
    the routing."""
    T, E = logits.shape
    _, gate_vals, expert_idx, aux_loss = _topk_gates(logits, k)
    dev = logits.device
    experts = torch.arange(E, device=dev)
    slots = torch.arange(capacity, device=dev)
    dispatch = torch.zeros((T, E, capacity), dtype=torch.float32, device=dev)
    combine = torch.zeros_like(dispatch)
    fill = torch.zeros(E, dtype=torch.int64, device=dev)
    for choice in range(k):
        e = expert_idx[:, choice]
        onehot_e = (e[:, None] == experts).long()               # (T, E)
        pos_in_e = torch.cumsum(onehot_e, dim=0) - onehot_e
        slot = (pos_in_e * onehot_e).sum(-1) + fill[e]          # (T,)
        keep = slot < capacity
        slot_oh = ((slot[:, None] == slots) & keep[:, None]).float()
        upd = onehot_e.float()[:, :, None] * slot_oh[:, None, :]
        dispatch = dispatch + upd
        combine = combine + upd * (gate_vals[:, choice]
                                   * keep)[:, None, None]
        fill = fill + onehot_e.sum(0)
    return dispatch, combine, aux_loss


def ragged_expert_apply(tokens, expert_idx, gate_vals, w_gate, w_up, w_down,
                        num_experts, act=F.silu):
    """Dropless expert compute: tokens (T, H), expert_idx / gate_vals
    (T, k), expert weights (E, H, M), (E, H, M), (E, M, H) -> (T, H).

    The T * k (token, choice) pairs are stably sorted by expert and each
    expert's rows go through its SwiGLU MLP by three grouped products
    (X1), with silu(gate) * up between them; each row is scaled by its
    gate value, the rows are put back in (token, choice) order by the
    inverse permutation and a token's k rows are added in choice order
    (no atomics). The group offsets are the JAX package's
    bincount-and-cumsum, computed as a search of the sorted expert ids
    (`torch.bincount` reads its maximum on the host on CUDA). Nothing
    here reads the device on the host."""
    T, H = tokens.shape
    k = expert_idx.shape[1]
    dev = tokens.device
    dtype = torch.promote_types(tokens.dtype, w_gate.dtype)
    flat_e = expert_idx.reshape(-1).to(torch.int32)
    sorted_e, order = torch.sort(flat_e, stable=True)
    offsets = torch.searchsorted(
        sorted_e, torch.arange(num_experts + 1, dtype=torch.int32,
                               device=dev), out_int32=True)
    x = tokens.to(dtype).index_select(0, order // k)            # (T k, H)
    w_gate, w_up, w_down = (w.to(dtype) for w in (w_gate, w_up, w_down))
    h = act(ops.moe_grouped_matmul(x, w_gate, offsets))
    h = h * ops.moe_grouped_matmul(x, w_up, offsets)
    y = ops.moe_grouped_matmul(h, w_down, offsets)              # (T k, H)
    y = y * gate_vals.reshape(-1)[order][:, None].to(y.dtype)
    inverse = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=dev))
    return y.index_select(0, inverse).view(T, k, H).sum(1)


def _normal(shape, dtype, device, generator):
    return torch.nn.Parameter(torch.empty(shape, dtype=dtype, device=device)
                              .normal_(0.0, 0.02, generator=generator))


class ExpertMLP(torch.nn.Module):
    """E SwiGLU experts' weights on a leading axis: w_up / w_gate
    (E, hidden, intermediate), w_down (E, intermediate, hidden), drawn
    from normal(0, 0.02) as in the JAX package."""

    def __init__(self, num_experts, hidden, intermediate, dtype=torch.float32,
                 device=None, generator=None, activation=F.silu):
        super().__init__()
        self.w_up = _normal((num_experts, hidden, intermediate), dtype,
                            device, generator)
        self.w_gate = _normal((num_experts, hidden, intermediate), dtype,
                              device, generator)
        self.w_down = _normal((num_experts, intermediate, hidden), dtype,
                              device, generator)
        self.act = activation

    def forward(self, x):
        """x: (E, C, hidden) expert-major buckets -> (E, C, hidden), the
        batched products 'ech,ehm->ecm' (as XLA computes the JAX
        package's einsums)."""
        h = self.act(x @ self.w_gate) * (x @ self.w_up)
        return h @ self.w_down


class MoELayer(torch.nn.Module):
    """Routed experts with optional shared experts (DeepSeek-style), over
    (B, S, hidden) inputs.

    `dispatch_mode`: 'dense' (GShard capacity dispatch), 'ragged'
    (dropless, the grouped product X1) or 'auto' (dense, with a warning
    at 16 experts or more, as the JAX package gives). `forward(x,
    dropless=True)` takes the ragged path whatever the mode (the cached
    forward does: a capacity computed from a one-token call would drop
    colliding tokens). Shared experts run on every token and are added.
    The router weight `gate` (hidden, E) is float32 (routing scores stay
    full precision: `no_quantize`), and the router logits are computed
    in the promoted dtype of the tokens and the gate, as the JAX
    package's `tokens @ gate`. `aux_loss` is a buffer holding the last
    forward's load-balance loss (the JAX layer's stashed value)."""

    no_quantize = ('gate',)

    def __init__(self, hidden, intermediate, num_experts=8, top_k=2,
                 capacity_factor=1.25, num_shared_experts=0,
                 return_aux=False, dispatch_mode='auto', dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        if dispatch_mode not in ('auto', 'dense', 'ragged'):
            raise ValueError(
                f"dispatch_mode must be 'auto'|'dense'|'ragged', "
                f'got {dispatch_mode}')
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        if dispatch_mode == 'auto':
            if num_experts >= 16:
                warnings.warn(
                    f'MoELayer(num_experts={num_experts}) defaults to the '
                    f'dense GShard dispatch, whose (tokens, E, C) tensors '
                    f"are O(T²); pass dispatch_mode='ragged' for the "
                    f'dropless grouped-GEMM path at this expert count.',
                    stacklevel=3)
            dispatch_mode = 'dense'
        self.dispatch_mode = dispatch_mode
        self.gate = _normal((hidden, num_experts), torch.float32, device,
                            generator)
        self.experts = ExpertMLP(num_experts, hidden, intermediate, dtype,
                                 device, generator)
        self.num_shared = num_shared_experts
        self.shared = (None if num_shared_experts == 0 else ExpertMLP(
            num_shared_experts, hidden, intermediate, dtype, device,
            generator))
        self.return_aux = return_aux
        self.register_buffer('aux_loss', torch.zeros(
            (), dtype=torch.float32, device=device))

    def forward(self, x, dropless=False):
        """x: (B, S, H) -> (B, S, H), or (out, aux_loss) with
        `return_aux`."""
        B, S, H = x.shape
        T = B * S
        tokens = x.reshape(T, H)
        dt = torch.promote_types(tokens.dtype, self.gate.dtype)
        logits = tokens.to(dt) @ self.gate.to(dt)
        if dropless or self.dispatch_mode == 'ragged':
            _, gate_vals, expert_idx, aux = _topk_gates(logits, self.top_k)
            out = ragged_expert_apply(
                tokens, expert_idx, gate_vals, self.experts.w_gate,
                self.experts.w_up, self.experts.w_down, self.num_experts,
                act=self.experts.act)
        else:
            capacity = max(int(self.capacity_factor * self.top_k * T
                               / self.num_experts), 1)
            dispatch, combine, aux = top_k_gating(logits, self.top_k,
                                                  capacity)
            expert_in = torch.einsum('tec,th->ech', dispatch, tokens.float())
            expert_out = self.experts(expert_in.to(x.dtype))
            out = torch.einsum('tec,ech->th', combine, expert_out.float())
        out = out.reshape(B, S, H).to(x.dtype)
        if self.shared is not None:
            shared_in = tokens[None].expand(self.num_shared, T, H)
            out = out + self.shared(shared_in).sum(0).reshape(B, S, H)
        with torch.no_grad():
            self.aux_loss.copy_(aux)
        if self.return_aux:
            return out, aux
        return out


__all__ = ['ExpertMLP', 'MoELayer', 'limit_by_capacity',
           'ragged_expert_apply', 'top_k_gating']
