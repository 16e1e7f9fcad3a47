"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``agg_quant.quantize_pack`` (codec q8/q4 stage),
``agg_robust.gram`` (Krum's Gram plane), ``conv.conv3x3_lanes`` /
``conv.conv3x3_dw_lanes`` (the 3x3 multi-weight conv in float32 or bf16,
its forward on the tensor cores from ``conv3x3_sm90`` for ResNet's block
convs and the stem (in bf16 and in float32), and its weight gradient, in bf16 at the block
widths from ``conv3x3_sm90`` too) and ``flash_attention.flash_forward`` / ``flash_dq`` /
``flash_dkv`` (causal flash attention and its backward; bf16 inputs on
the tensor cores from ``flash_attention_sm90``, at Dh 256 from
``flash_dh256_sm90``, at Dh 384 from ``flash_dh384_sm90``, at Dh 512-1536
from ``flash_wide_sm90``; float32 at Dh 256 and 384 and the float32
forward at Dh 128 on the tensor cores from ``flash_f32_sm90``, the float32
dq and dk/dv at Dh 128 on wgmma from ``flash_f32_wgmma_sm90``, and all
three at Dh 512 there too as clusters of four blocks, one per 128-column
slice, float32 at Dh 640-896 from ``flash_wide_f32_sm90``; float32 at Dh
64 on the FMA
kernels of ``flash_attention``). Sources are in ``../csrc``."""

KERNELS = ("agg_quant", "agg_robust", "conv3x3", "conv3x3_sm90", "flash_attention",
           "flash_attention_sm90", "flash_dh256_sm90", "flash_dh384_sm90", "flash_f32_sm90",
           "flash_f32_wgmma_sm90", "flash_wide_sm90", "flash_wide_f32_sm90")
