from .engine import (CacheExhausted, ContinuousBatchingEngine,
                     EngineOverloaded, RequestCancelled)
from .serve import PredictorServer

__all__ = ["ContinuousBatchingEngine", "EngineOverloaded", "CacheExhausted",
           "RequestCancelled", "PredictorServer"]
