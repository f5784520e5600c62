"""LLaMA-family LLM runtime of the PyTorch port (GGUF loader, tokenizer,
chunked generation on the device).

Counterpart of the llama.cpp build vendored by the reference's
talk-llama example (examples/talk-llama/ in the reference).
"""

from .model import (LlamaConfig, LlamaContext, SampleParams,  # noqa: F401
                    config_from_gguf, forward, generate_chunk,
                    init_kv_cache, init_params, params_from_gguf)
from .tokenizer import LlamaVocab  # noqa: F401
