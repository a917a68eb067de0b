from .generation import generate, new_kv_caches
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel, gpt_125m, gpt_1p3b,
                  gpt_tiny)

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt_tiny",
           "gpt_125m", "gpt_1p3b", "generate", "new_kv_caches"]
