"""Host-side data pipeline (counterpart of ``bayesian_torch_tpu.data``)."""

from bayesian_torch_tpu_torch.data.loader import (  # noqa: F401
    DataLoader,
    native_available,
)
