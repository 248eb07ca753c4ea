from .step import init_train_state, make_train_step

__all__ = ["make_train_step", "init_train_state"]
