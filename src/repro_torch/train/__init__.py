from .region_step import init_ef_state, make_region_train_step
from .step import TrainConfig, init_state, make_train_step

__all__ = ["TrainConfig", "init_state", "make_train_step",
           "make_region_train_step", "init_ef_state"]
