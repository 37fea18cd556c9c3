from .cnn import CIFAR10_CNN, MLP, MNIST_CNN, DishesCNN
from .decoding import KVCacheDecoder, LlamaKVCacheDecoder, MixtralKVCacheDecoder
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
from .transformer_lm import TransformerLM
from .vgg import VGG, VGG16
from .vit import EncoderBlock, VisionTransformer, ViT_Tiny

__all__ = [
    "BasicBlock",
    "Bottleneck",
    "CIFAR10_CNN",
    "DishesCNN",
    "EncoderBlock",
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
    "TransformerLM",
    "VGG",
    "VGG16",
    "ViT_Tiny",
    "VisionTransformer",
    "make_divisible",
]
