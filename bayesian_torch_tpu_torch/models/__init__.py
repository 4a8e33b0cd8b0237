"""Model zoo (ImageNet ResNets, the CIFAR ResNets and the MNIST SCNN) and
model surgery: ``dnn_to_bnn``, ``get_kl_loss``, ``bnn_to_qbnn`` and
``batch_norm_folding``."""

from bayesian_torch_tpu_torch.models.dnn_to_bnn import (  # noqa: F401
    dnn_to_bnn,
    get_kl_loss,
)
from bayesian_torch_tpu_torch.models.bnn_to_qbnn import (  # noqa: F401
    batch_norm_folding,
    bnn_to_qbnn,
)
