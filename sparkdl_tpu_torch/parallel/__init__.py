"""Parallelism toolkit of the port over a named ``DeviceMesh``
(``core.runtime.make_mesh``): sharding rules placed as ``DTensor``s
(DP/TP/FSDP/LoRA, sharding.py), sharded parameters and the conjugate
collectives of the FSDP×TP step (fsdp.py), sequence parallelism (ring
attention, Ulysses; ring_attention.py), expert parallelism (SwitchMoE,
moe.py) and pipeline parallelism (GPipe, pipeline.py)."""

from .ring_attention import (NEG_INF, dense_attention, ring_attention,
                             ulysses_attention)
from .sharding import (P, NamedSharding, SpecLayout, describe,
                       dispatch_counter, divisible_rules, fsdp_rules,
                       head_sharded_kernel, local_heads, lora_rules,
                       make_rules, path_str, placements,
                       serving_tp_layout, shard_params, sharding_pytree,
                       transformer_tp_rules)
from .fsdp import shard_module
from .moe import SwitchMoE, moe_aux_loss, moe_rules
from .pipeline import gpipe, microbatch, stack_stage_params, stage_sharding

__all__ = [
    "make_rules", "shard_params", "sharding_pytree", "describe",
    "transformer_tp_rules", "lora_rules", "fsdp_rules",
    "SpecLayout", "serving_tp_layout", "divisible_rules",
    "ring_attention", "ulysses_attention", "dense_attention",
    "gpipe", "microbatch", "stack_stage_params", "stage_sharding",
    "SwitchMoE", "moe_rules", "moe_aux_loss",
    "NEG_INF", "P", "NamedSharding", "placements", "path_str",
    "head_sharded_kernel", "local_heads", "dispatch_counter",
    "shard_module",
]
