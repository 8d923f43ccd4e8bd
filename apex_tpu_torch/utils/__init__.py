from apex_tpu_torch.utils.platform import resolve_device

__all__ = ["resolve_device"]
