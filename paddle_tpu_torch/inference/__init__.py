"""Inference: the predictor over ``jit.save`` artifacts, the
continuous-batching engine and the HTTP server over both (port of
paddle_tpu/inference/)."""
from .engine import (CacheExhausted, ContinuousBatchingEngine,
                     EngineOverloaded, RequestCancelled)
from .predictor import (Config, DataType, PrecisionType, Predictor,
                        PredictorPool, Tensor, create_predictor,
                        get_num_bytes_of_data_type, get_version)
from .serve import PredictorServer

__all__ = ["ContinuousBatchingEngine", "EngineOverloaded", "CacheExhausted",
           "RequestCancelled", "PredictorServer", "Config", "Predictor",
           "create_predictor", "Tensor", "DataType",
           "PrecisionType", "PredictorPool", "get_version",
           "get_num_bytes_of_data_type"]
