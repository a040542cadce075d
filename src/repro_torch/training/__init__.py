from repro_torch.training.train_step import TrainState, make_train_step, train_state_shardings

__all__ = ["TrainState", "make_train_step", "train_state_shardings"]
