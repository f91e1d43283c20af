"""Distributed and expert-parallel building blocks (counterpart of
paddle_tpu/distributed). Ported so far: the Mixture-of-Experts layer and
its gating (`moe`), on one device; expert and tensor parallelism are not
ported (ROADMAP A5)."""
from .moe import (ExpertMLP, MoELayer, limit_by_capacity,
                  ragged_expert_apply, top_k_gating)

__all__ = ['ExpertMLP', 'MoELayer', 'limit_by_capacity',
           'ragged_expert_apply', 'top_k_gating']
