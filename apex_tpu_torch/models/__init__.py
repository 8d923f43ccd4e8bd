from apex_tpu_torch.models.bert import BertConfig, BertModel
from apex_tpu_torch.models.gpt import GPTConfig, GPTDecodeFns, GPTModel

__all__ = ["BertConfig", "BertModel", "GPTConfig", "GPTDecodeFns", "GPTModel"]
