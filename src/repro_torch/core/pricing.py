"""Commercial API $/M-token tiers (the paper's §6.3 reference list prices).

Counterpart of `repro.core.pricing` without `chip_hour_price`: that reads
the reference's TPU hardware book, and the port prices its live tier at a
caller-given $/hr until an H100 entry exists.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class APITier:
    name: str
    input_per_mtok: float
    output_per_mtok: float

    def blended(self, in_tokens: float, out_tokens: float) -> float:
        """$ per M *output* tokens for a workload shape, billing both sides
        at list price (paper §6.3 back-of-envelope convention)."""
        total = (in_tokens * self.input_per_mtok +
                 out_tokens * self.output_per_mtok)
        return total / out_tokens


# Paper §6.3 list prices.
API_TIERS: Dict[str, APITier] = {
    "gpt-5.5": APITier("gpt-5.5", 5.00, 30.00),
    "claude-sonnet-4.6": APITier("claude-sonnet-4.6", 3.00, 15.00),
    "gemini-3.1-pro": APITier("gemini-3.1-pro", 2.00, 12.00),
}
