"""Parallelism on one controller (the JAX package's ``parallel/``): the
device mesh and sequence parallelism over a ring. Sharding, pipelines,
multi-host runs, overlap and the planner are not ported yet (ROADMAP.md
queue 1, parallelism on torch.distributed)."""
from koifish_tpu_torch.parallel.mesh import (Mesh, make_mesh,  # noqa: F401
                                             mesh_shape_for)
from koifish_tpu_torch.parallel.ring_attention import (  # noqa: F401
    ring_attention_sharded)
from koifish_tpu_torch.parallel.ring_pallas import (  # noqa: F401
    fits_vmem, ring_attention_pallas_sharded)
