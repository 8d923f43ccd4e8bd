from apex_tpu_torch.models.gpt import GPTConfig, GPTDecodeFns, GPTModel

__all__ = ["GPTConfig", "GPTDecodeFns", "GPTModel"]
