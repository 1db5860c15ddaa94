"""A rate over the whole window."""

from __future__ import annotations


def rate(amount: float, seconds: float) -> float:
    """Work over the whole window: all of it, over all of its seconds."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return amount / seconds
