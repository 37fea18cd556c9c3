from .cnn import MLP
from .decoding import KVCacheDecoder, LlamaKVCacheDecoder, MixtralKVCacheDecoder
from .llama import LlamaBlock, LlamaLM
from .mixtral import MixtralBlock, MixtralLM
from .transformer_lm import TransformerLM
from .vit import EncoderBlock

__all__ = [
    "MLP",
    "EncoderBlock",
    "KVCacheDecoder",
    "LlamaBlock",
    "LlamaKVCacheDecoder",
    "LlamaLM",
    "MixtralBlock",
    "MixtralKVCacheDecoder",
    "MixtralLM",
    "TransformerLM",
]
