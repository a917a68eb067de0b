"""Inference: the predictor over ``jit.save`` artifacts, the
continuous-batching engine, the HTTP server over both and the router over
replica processes of that server (port of paddle_tpu/inference/)."""
from .engine import (CacheExhausted, ContinuousBatchingEngine,
                     EngineOverloaded, GenerationPredictor,
                     RequestCancelled, create_engine_predictor)
from .predictor import (Config, DataType, PrecisionType, Predictor,
                        PredictorPool, Tensor, create_predictor,
                        get_num_bytes_of_data_type, get_version)
from .router import Replica, ReplicaSpec, Router
from .serve import PredictorServer
from .speculative import (DraftModelProposer, NGramProposer,
                          SpeculativeConfig)

__all__ = ["Config", "Predictor", "create_predictor", "Tensor", "DataType",
           "PrecisionType", "PredictorPool", "ContinuousBatchingEngine",
           "EngineOverloaded", "CacheExhausted", "RequestCancelled",
           "GenerationPredictor", "create_engine_predictor",
           "SpeculativeConfig", "NGramProposer", "DraftModelProposer",
           "PredictorServer",
           "Router", "ReplicaSpec", "Replica",
           "get_version", "get_num_bytes_of_data_type"]
