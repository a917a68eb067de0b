from .bert import (BertConfig, BertForMaskedLM, BertForSequenceClassification,
                   BertModel, ErnieModel, bert_base, bert_tiny, ernie_3_base,
                   ernie_3_tiny)
from .generation import generate, new_kv_caches
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel, gpt_1p3b, gpt_6p7b,
                  gpt_125m, gpt_tiny)
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel, llama_7b,
                    llama_13b, llama_tiny)

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt_tiny",
           "gpt_125m", "gpt_1p3b", "gpt_6p7b", "LlamaConfig", "LlamaModel",
           "LlamaForCausalLM", "llama_tiny", "llama_7b", "llama_13b",
           "BertConfig", "BertModel", "ErnieModel",
           "BertForSequenceClassification", "BertForMaskedLM", "bert_tiny",
           "bert_base", "ernie_3_tiny", "ernie_3_base", "generate",
           "new_kv_caches"]
