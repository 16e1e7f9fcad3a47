"""Cheetah, the distributed-training plane (port of ``fedml_tpu/parallel``):
the causal-LM trainer on one device. Meshes, shardings and collectives wait
for ROADMAP.md Queue 1 item 10."""

from .trainer import DistTrainConfig, DistributedLMTrainer

__all__ = ["DistTrainConfig", "DistributedLMTrainer"]
