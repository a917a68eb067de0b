from .generation import generate, new_kv_caches
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel, gpt_125m, gpt_1p3b,
                  gpt_tiny)
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel, llama_7b,
                    llama_13b, llama_tiny)

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt_tiny",
           "gpt_125m", "gpt_1p3b", "LlamaConfig", "LlamaModel",
           "LlamaForCausalLM", "llama_tiny", "llama_7b", "llama_13b",
           "generate", "new_kv_caches"]
