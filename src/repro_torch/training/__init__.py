from repro_torch.training.train import TrainState, Trainer, TrainerConfig

__all__ = ["TrainState", "Trainer", "TrainerConfig"]
