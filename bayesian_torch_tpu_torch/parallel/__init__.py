"""Monte-Carlo forwards, process meshes, tensor parallelism and
multi-process initialization (counterpart of
``bayesian_torch_tpu.parallel``)."""

from bayesian_torch_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    reduce_gradients,
    replicate,
    shard_batch,
)
from bayesian_torch_tpu_torch.parallel.mc import (  # noqa: F401
    mc_forward,
    mc_vmap,
)
from bayesian_torch_tpu_torch.parallel.distributed import (  # noqa: F401
    initialize,
)
from bayesian_torch_tpu_torch.parallel.tp import shard_params_tp  # noqa: F401
