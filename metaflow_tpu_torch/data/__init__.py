"""Data orderings shared by the port's token loaders
(training/data.py)."""

from .ordering import STATE_KEY, hierarchical_window_order

__all__ = ["STATE_KEY", "hierarchical_window_order"]
