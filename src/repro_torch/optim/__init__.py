"""Optimizers of the port (counterpart of `repro.optim`)."""

from repro_torch.optim.adamw import adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.schedules import warmup_cosine  # noqa: F401
