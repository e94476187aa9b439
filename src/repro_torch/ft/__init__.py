"""Fault tolerance: the serving side's request rebalance."""
