from apex_tpu_torch.models.bert import BertConfig, BertModel
from apex_tpu_torch.models.gpt import GPTConfig, GPTDecodeFns, GPTModel
from apex_tpu_torch.models.resnet import ResNet, ResNetConfig, resnet50
from apex_tpu_torch.models.t5 import T5Config, T5Model

__all__ = ["BertConfig", "BertModel", "GPTConfig", "GPTDecodeFns", "GPTModel",
           "ResNet", "ResNetConfig", "resnet50", "T5Config", "T5Model"]
