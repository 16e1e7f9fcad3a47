"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``agg_quant.quantize_pack`` (codec q8/q4 stage) and
``agg_robust.gram`` (Krum's Gram plane). Sources are in ``../csrc``."""

KERNELS = ("agg_quant", "agg_robust")
