"""Parallelism (the JAX package's ``parallel/``): the device mesh and
sequence parallelism over a ring on one controller; data, tensor, FSDP and
pipeline parallelism one rank a process over ``torch.distributed``
(``ProcessMesh``, ``sharding``, ``pipeline``, ``multihost``, ``overlap``);
and the memory planner."""
from koifish_tpu_torch.parallel.mesh import (Mesh, ProcessMesh,  # noqa: F401
                                             make_mesh, make_process_mesh,
                                             mesh_shape_for)
from koifish_tpu_torch.parallel.planner import (  # noqa: F401
    MemoryPlan, plan_serving, plan_training)
from koifish_tpu_torch.parallel.ring_attention import (  # noqa: F401
    ring_attention_sharded)
from koifish_tpu_torch.parallel.ring_pallas import (  # noqa: F401
    fits_vmem, ring_attention_pallas_sharded)
from koifish_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_spec, constrain_activations, param_specs, shard_params)
