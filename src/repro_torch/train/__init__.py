from repro_torch.train.step import (  # noqa: F401
    build_train_step, build_train_step_compressed_dp, cross_entropy,
    init_train_state,
)
from repro_torch.train.loop import LoopConfig, train_loop  # noqa: F401
