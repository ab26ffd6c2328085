"""Entry points: `serve` runs the live cost-metered server."""
