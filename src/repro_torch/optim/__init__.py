from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig, adamw_init, adamw_update, cosine_schedule, global_norm,
    wsd_schedule,
)
