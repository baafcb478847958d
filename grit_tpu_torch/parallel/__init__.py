"""Data and tensor parallel over ``torch.distributed`` (grit_tpu/parallel's
counterpart: its mesh's ``data`` and ``model`` axes)."""

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
    gather_tp_state,
    global_sum,
    make_groups,
    pad_to_multiple,
    shard_batch,
    shard_model,
    tp_plan,
    unwrap,
    wrap_data_parallel,
)
from grit_tpu_torch.parallel.tensor import copy_to_tp, gather_from_tp, reduce_from_tp  # noqa: F401
