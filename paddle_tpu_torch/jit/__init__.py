from .api import InputSpec, TranslatedLayer, load, save
from .training import TrainStep

__all__ = ["TrainStep", "InputSpec", "save", "load", "TranslatedLayer"]
