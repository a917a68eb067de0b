from .engine import (ContinuousBatchingEngine, EngineOverloaded,
                     RequestCancelled)
from .serve import PredictorServer

__all__ = ["ContinuousBatchingEngine", "EngineOverloaded",
           "RequestCancelled", "PredictorServer"]
