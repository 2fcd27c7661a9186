"""The port's model zoo: GPT, the MNIST MLP, the ResNet family, VGG,
Inception V3 and BERT, each a port of its namesake in
``horovod_tpu/models/``."""

from .bert import (BERT_BASE, BERT_LARGE, BERT_TINY,  # noqa: F401
                   BertConfig, BertEncoder, BertForPreTraining, mlm_loss)
from .convert import (from_jax, gpt_params_from_jax,  # noqa: F401
                      gpt_params_to_jax, to_jax)
from .gpt import GPT, GPT_SMALL, GPT_TINY, GPTConfig, lm_loss  # noqa: F401
from .inception import InceptionV3  # noqa: F401
from .mlp import MLP, xent_loss  # noqa: F401
from .resnet import (ResNet, ResNet18, ResNet34, ResNet50,  # noqa: F401
                     ResNet101, ResNet152, ResNetTiny)
from .vgg import VGG, VGG16, VGG19, VGGTiny  # noqa: F401
