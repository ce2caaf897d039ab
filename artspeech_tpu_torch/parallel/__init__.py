"""Data parallelism over ``torch.distributed`` (counterpart of
artspeech_tpu/parallel/): the (data, model) mesh, placements, state
distribution, one sharded step, and ``dryrun_multichip`` (parallel/dryrun.py).
"""

from artspeech_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    data_parallel_mesh,
    make_mesh,
    params_shardings,
    replicated,
    shard_batch,
)
from artspeech_tpu_torch.parallel.distributed import (
    distribute_state,
    initialize_multihost,
    run_distributed_step,
)
