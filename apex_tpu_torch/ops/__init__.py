"""The port's kernels: each module holds a hand-written Hopper kernel, its
plain PyTorch version and the wrapper that picks by the tensor's device."""

from apex_tpu_torch.ops.attention import flash_attention, mha_reference
from apex_tpu_torch.ops.attention_decode import (
    fmha_decode,
    paged_attention_reference,
)
from apex_tpu_torch.ops.attention_flash import (
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_fwd,
)
from apex_tpu_torch.ops.attention_mid import fmha_mid, mid_bwd, mid_fwd
from apex_tpu_torch.ops.attention_short import fmha_short, short_bwd, short_fwd
from apex_tpu_torch.ops.common import (
    KernelUnavailable,
    launch_counts,
    reset_launch_counts,
)
from apex_tpu_torch.ops.dequant_matmul import (
    dequant_matmul,
    dequant_matmul_reference,
    quantize_weight,
)
from apex_tpu_torch.ops.layer_norm import (
    fused_layer_norm,
    fused_layer_norm_affine,
    fused_rms_norm,
    fused_rms_norm_affine,
    layer_norm_bwd,
    layer_norm_fwd,
    mixed_dtype_fused_layer_norm_affine,
)
from apex_tpu_torch.ops.softmax import (
    scaled_masked_softmax,
    scaled_softmax,
    scaled_upper_triang_masked_softmax,
)
from apex_tpu_torch.ops.rope import (
    apply_rope,
    apply_rope_at,
    apply_rope_tables,
    rope_cos_sin,
    rope_table,
)

__all__ = [
    "KernelUnavailable", "apply_rope", "apply_rope_at", "apply_rope_tables",
    "dequant_matmul", "dequant_matmul_reference", "flash_attention",
    "flash_bwd_dkv", "flash_bwd_dq", "flash_fwd",
    "fmha_decode", "fmha_mid", "fmha_short", "fused_layer_norm",
    "fused_layer_norm_affine", "fused_rms_norm", "fused_rms_norm_affine",
    "launch_counts", "layer_norm_bwd", "layer_norm_fwd", "mha_reference",
    "mid_bwd", "mid_fwd", "mixed_dtype_fused_layer_norm_affine",
    "paged_attention_reference", "quantize_weight", "reset_launch_counts",
    "rope_cos_sin", "rope_table",
    "scaled_masked_softmax", "scaled_softmax",
    "scaled_upper_triang_masked_softmax", "short_bwd", "short_fwd",
]
