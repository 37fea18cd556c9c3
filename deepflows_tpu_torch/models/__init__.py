from .cnn import MLP
from .decoding import KVCacheDecoder
from .transformer_lm import TransformerLM
from .vit import EncoderBlock

__all__ = ["MLP", "EncoderBlock", "KVCacheDecoder", "TransformerLM"]
