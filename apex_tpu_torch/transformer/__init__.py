from apex_tpu_torch.transformer import parallel_state, tensor_parallel

__all__ = ["parallel_state", "tensor_parallel"]
