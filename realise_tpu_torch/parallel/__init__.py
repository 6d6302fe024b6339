"""Multi-GPU data and tensor parallelism on ``torch.distributed`` (the port
of ``realise_tpu.parallel``): one process per card, launched by torchrun."""

from realise_tpu_torch.parallel.distributed import (  # noqa: F401
    barrier,
    gather_rows,
    initialize,
    is_main_process,
    local_slice,
    pad_to_multiple,
    process_count,
    process_index,
)
from realise_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    param_shardings,
)
from realise_tpu_torch.parallel.tensor import (  # noqa: F401
    MeshGroups,
    gather_state_dict,
    mesh_groups,
    shard_module,
)
