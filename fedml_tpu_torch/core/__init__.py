"""Core: partitioning, the algorithm frame, robust aggregation and DP
accounting."""

from .dp import epsilon_for_training, rdp_epsilon

__all__ = ["epsilon_for_training", "rdp_epsilon"]
