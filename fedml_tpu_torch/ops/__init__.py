"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``agg_quant.quantize_pack`` (codec q8/q4 stage),
``agg_robust.gram`` (Krum's Gram plane) and ``conv.conv3x3_lanes`` /
``conv.conv3x3_dw_lanes`` (the 3x3 multi-weight conv and its weight
gradient). Sources are in ``../csrc``."""

KERNELS = ("agg_quant", "agg_robust", "conv3x3")
