"""Training and slide inference across processes, one card each (port of
``hd_yolo_tpu/parallel/``), on ``torch.distributed``.

The JAX package runs one program over a mesh of devices: ``shard_batch`` /
``make_global_batch`` assemble a global array from each process's rows and
XLA inserts the collectives.  Here each rank is a process that holds only its
own rows, so those two have no counterpart: :func:`local_slice` cuts a rank's
rows of a global batch, :func:`all_gather_rows` gathers the rows of every
rank where a step needs the whole batch (the device recipe's mosaic and mixup
partners, the sharded slide's outputs), and the step's collectives are
explicit: :func:`global_batch` (BatchNorm statistics, loss counts and random
draws over the group) and :func:`all_reduce_grads`.  ``batch_sharding`` /
``replicated`` place arrays on a mesh and have no counterpart either;
``auto_mesh`` checks that the global batch splits over the ranks.
``create_mesh`` builds a ``(data, model)`` ``DeviceMesh`` and
``shard_params_tp`` places the parameters on it (``mesh.py``).

Launch: ``python -m torch.distributed.run --standalone --nproc_per_node N -m
hd_yolo_tpu_torch.engines.train ...`` (NCCL, ``cuda:LOCAL_RANK``), or with
``--device cpu`` on gloo.
"""

from .distributed import (  # noqa: F401
    all_gather_rows,
    all_reduce_grads,
    all_sum,
    barrier,
    batch_count,
    broadcast_object,
    draw_rows,
    global_mean,
    global_batch,
    is_initialized,
    is_main_process,
    local_device,
    maybe_initialize_distributed,
    rank,
    step_group,
    world_size,
)
from .mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    auto_mesh,
    create_mesh,
    local_slice,
    make_mesh_train_step,
    replicate,
    reshard_params,
    shard_params_tp,
    tp_placement,
    unshard_params,
)
