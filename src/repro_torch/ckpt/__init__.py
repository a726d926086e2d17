from repro_torch.ckpt.checkpoint import (  # noqa: F401
    gc_old, latest_step, restore, save_atomic,
)
