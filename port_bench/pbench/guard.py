"""Keeps JAX and the JAX package out of a benchmark run.

Names are compared by their top-level part, the part before the first
dot, whole: `nnop_tpu_torch` passes and `nnop_tpu` does not."""

from __future__ import annotations

import importlib.abc
import sys

BANNED = ("jax", "jaxlib", "flax", "nnop_tpu")


def top_level(name: str) -> str:
    return name.partition(".")[0]


def is_banned(name: str) -> bool:
    return top_level(name) in BANNED


class _Refuse(importlib.abc.MetaPathFinder):
    """A finder ahead of all others that refuses the banned names."""

    def find_spec(self, name, path=None, target=None):
        if is_banned(name):
            raise ModuleNotFoundError(f"the benchmark refuses to import {name!r}", name=name)
        return None


def install() -> None:
    if not any(isinstance(f, _Refuse) for f in sys.meta_path):
        sys.meta_path.insert(0, _Refuse())


def banned_loaded(modules=None) -> list[str]:
    """The banned top-level names among `modules` (default: sys.modules)."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(m) for m in names if is_banned(m)})
