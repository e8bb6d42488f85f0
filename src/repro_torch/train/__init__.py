from .step import TrainConfig, init_state, make_train_step

__all__ = ["TrainConfig", "init_state", "make_train_step"]
