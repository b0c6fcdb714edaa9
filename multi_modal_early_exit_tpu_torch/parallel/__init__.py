"""Data and Megatron tensor parallelism over ``torch.distributed``: the
counterpart of the JAX package's ``parallel/`` (one process per device
here, the collectives written out by hand; see ``mesh.py``)."""

from multi_modal_early_exit_tpu_torch.parallel.mesh import (  # noqa: F401
    create_mesh,
    default_mesh_shape,
)
from multi_modal_early_exit_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_sharding,
    param_partition_specs,
    shard_batch,
    shard_params,
)
