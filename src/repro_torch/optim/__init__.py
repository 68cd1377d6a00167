"""AdamW and learning-rate schedules (the port of ``repro.optim``)."""
from repro_torch.optim import adamw, schedule  # noqa: F401
from repro_torch.optim.adamw import AdamWConfig  # noqa: F401
from repro_torch.optim.schedule import ScheduleConfig, lr_at  # noqa: F401
