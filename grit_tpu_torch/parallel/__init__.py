"""Data parallel over ``torch.distributed`` (grit_tpu/parallel's counterpart)."""

from grit_tpu_torch.parallel.distributed import (  # noqa: F401
    allgather_pyobj,
    barrier,
    is_main_process,
    maybe_initialize,
    rank,
    run_ranks,
    world_size,
)
from grit_tpu_torch.parallel.mesh import (  # noqa: F401
    global_sum,
    pad_to_multiple,
    shard_batch,
    unwrap,
    wrap_data_parallel,
)
