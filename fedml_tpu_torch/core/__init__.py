"""Core: partitioning, the algorithm frame and robust aggregation."""
