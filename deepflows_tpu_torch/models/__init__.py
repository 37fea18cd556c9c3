from .cnn import CIFAR10_CNN, MLP, MNIST_CNN, DishesCNN
from .decoding import KVCacheDecoder, LlamaKVCacheDecoder, MixtralKVCacheDecoder
from .engine import InflightEngine, InflightHandle
from .llama import LlamaBlock, LlamaLM
from .mixtral import MixtralBlock, MixtralLM
from .mobilenet import InvertedResidual, MobileNetV1, MobileNetV2, make_divisible
from .resnet import (
    BasicBlock,
    Bottleneck,
    ResidualBlock,
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
)
from .seq2seq import CrossDecoderBlock, Seq2SeqGenerator, Seq2SeqTransformer
from .speculative import SpeculativeDecoder
from .transformer_lm import TransformerLM
from .vgg import VGG, VGG16
from .vit import EncoderBlock, VisionTransformer, ViT_Tiny

__all__ = [
    "BasicBlock",
    "Bottleneck",
    "CIFAR10_CNN",
    "CrossDecoderBlock",
    "DishesCNN",
    "EncoderBlock",
    "InflightEngine",
    "InflightHandle",
    "InvertedResidual",
    "KVCacheDecoder",
    "LlamaBlock",
    "LlamaKVCacheDecoder",
    "LlamaLM",
    "MLP",
    "MNIST_CNN",
    "MixtralBlock",
    "MixtralKVCacheDecoder",
    "MixtralLM",
    "MobileNetV1",
    "MobileNetV2",
    "ResNet",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "ResidualBlock",
    "Seq2SeqGenerator",
    "Seq2SeqTransformer",
    "SpeculativeDecoder",
    "TransformerLM",
    "VGG",
    "VGG16",
    "ViT_Tiny",
    "VisionTransformer",
    "make_divisible",
]
