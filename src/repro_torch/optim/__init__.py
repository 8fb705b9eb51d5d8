from repro_torch.optim.adamw import AdamWConfig, AdamWState, init, update
from repro_torch.optim import schedules

__all__ = ["AdamWConfig", "AdamWState", "init", "update", "schedules"]
