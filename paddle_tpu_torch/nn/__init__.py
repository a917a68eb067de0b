"""Neural-network layers and functionals (port of paddle_tpu/nn/): the
``Layer`` system (``Layer``, ``ParamAttr``, ``initializer``), the layers
of ``nn/layer/``, the clips and ``nn.utils``."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from . import utils  # noqa: F401
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layers
from .layer_base import Layer, ParamAttr
from .utils import parameters_to_vector, vector_to_parameters

__all__ = ["functional", "initializer", "utils", "Layer", "ParamAttr",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "parameters_to_vector", "vector_to_parameters"] + list(_layers)
