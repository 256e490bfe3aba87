"""Growth engine: in-round preferential-attachment joins.

Ports ``tpu_gossip/growth/``: seeds bootstrapping new peers into a
power-law topology by degree-preferential subset handout, as a batched
membership plane inside the round. A growing swarm runs at a fixed
capacity and flips reserved rows live in per-round batches, bit for bit
as the JAX package does.
"""

from tpu_gossip_torch.growth.engine import (
    GROWTH_STREAM_SALT,
    apply_growth,
    gumbel_top_k,
    hill_gamma_device,
    realized_degrees,
)
from tpu_gossip_torch.growth.plan import (
    CompiledGrowth,
    GrowthError,
    compile_growth,
    matching_admit_rows,
    pad_graph_for_growth,
)

__all__ = [
    "GROWTH_STREAM_SALT",
    "CompiledGrowth",
    "GrowthError",
    "apply_growth",
    "compile_growth",
    "gumbel_top_k",
    "hill_gamma_device",
    "matching_admit_rows",
    "pad_graph_for_growth",
    "realized_degrees",
]
