"""Price books: accelerator $/chip-hr and commercial API $/M-token tiers.

API list prices are the paper's own reference tiers (§6.3, accessed
2026-06-09): asymmetric input/output pricing is retained so the crossover
analysis can price blended workload shapes (§6.3's extension) as well as
the paper's headline output-token basis.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.simulate.hardware import HW_BY_NAME


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


def chip_hour_price(hw_name: str, n_chips: int = 1) -> float:
    return HW_BY_NAME[hw_name].price_per_chip_hr * n_chips
