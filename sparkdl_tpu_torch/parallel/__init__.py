"""Parallelism toolkit of the port: sharding rules placed as ``DTensor``s
(DP/TP/FSDP/LoRA) and sequence parallelism (ring attention, Ulysses) over
a named ``DeviceMesh`` (``core.runtime.make_mesh``). See sharding.py and
ring_attention.py.

Pipeline parallelism (``gpipe`` and its helpers) and expert parallelism
(``SwitchMoE``) are not ported yet: those names raise
``NotImplementedError`` (ROADMAP.md, Queue A 8)."""

from .ring_attention import (NEG_INF, dense_attention, ring_attention,
                             ulysses_attention)
from .sharding import (P, NamedSharding, SpecLayout, describe,
                       dispatch_counter, divisible_rules, fsdp_rules,
                       head_sharded_kernel, local_heads, lora_rules,
                       make_rules, path_str, placements,
                       serving_tp_layout, shard_params, sharding_pytree,
                       transformer_tp_rules)


def _not_ported(name: str, module: str):
    def stub(*args, **kwargs):
        raise NotImplementedError(
            f"parallel.{name} ({module}) is not ported yet (ROADMAP.md, "
            f"Queue A 8)")
    stub.__name__ = stub.__qualname__ = name
    return stub


gpipe = _not_ported("gpipe", "pipeline.py")
microbatch = _not_ported("microbatch", "pipeline.py")
stack_stage_params = _not_ported("stack_stage_params", "pipeline.py")
stage_sharding = _not_ported("stage_sharding", "pipeline.py")
SwitchMoE = _not_ported("SwitchMoE", "moe.py")
moe_rules = _not_ported("moe_rules", "moe.py")
moe_aux_loss = _not_ported("moe_aux_loss", "moe.py")

__all__ = [
    "make_rules", "shard_params", "sharding_pytree", "describe",
    "transformer_tp_rules", "lora_rules", "fsdp_rules",
    "SpecLayout", "serving_tp_layout", "divisible_rules",
    "ring_attention", "ulysses_attention", "dense_attention",
    "gpipe", "microbatch", "stack_stage_params", "stage_sharding",
    "SwitchMoE", "moe_rules", "moe_aux_loss",
    "NEG_INF", "P", "NamedSharding", "placements", "path_str",
    "head_sharded_kernel", "local_heads", "dispatch_counter",
]
