from .training import TrainStep

__all__ = ["TrainStep"]
