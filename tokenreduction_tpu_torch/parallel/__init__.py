from tokenreduction_tpu_torch.parallel.launch import (  # noqa: F401
    dryrun_multichip,
)
from tokenreduction_tpu_torch.parallel.mesh import (  # noqa: F401
    DataParallel,
    LeafShard,
    fsdp_shardings,
    global_order,
    global_rows,
    init_distributed,
    process_count,
    process_index,
    shard_params,
)
