"""Failure classification of solves (the verdicts the streaming solver
reads). The recovery ladder, policy and chaos modules are not ported yet."""
from __future__ import annotations

from .health import VERDICTS, SolveHealth, classify, warm_is_poisoned

__all__ = ["VERDICTS", "SolveHealth", "classify", "warm_is_poisoned"]
