"""Concurrency-aware capacity planner.

Everything upstream of this package *reports* the paper's cost surface
C_eff = f(H, M, Q, lambda, L); this package *inverts* it into the
operator's actual decision: given my offered rate lambda and my SLO,
what should I deploy, and at what $/M-tokens?

  curves.py   — fit per-(model, hw, quant, n_chips) lambda -> (C_eff,
                util, TTFT/TPOT percentiles, concurrency) interpolators
                from any consolidated store (the dense `paper_atlas`
                continuum preferred; sparse 7-point ladders accepted
                with extrapolation flags), all through the hardened
                `core.crossover.interp_loglog` primitive.
  optimize.py — enumerate (hw, quant, n_chips) x replica-count
                deployments (each replica serves lambda/R: concurrency
                falls, penalty rises — priced, not hidden), a
                Mélange-style greedy heterogeneous mix across hardware
                generations, SLO feasibility, and the per-API-tier
                crossover verdict via the §6.4-gated `crossover_table`.
  allocate.py — the exact branch-and-bound replica allocator that
                *certifies* `greedy_mix`: same decision space, same
                evaluation, provable optimality gap per instance.
  portfolio.py— the `Workload` spec (per-class lambda, token budget,
                model-eligibility tiers) and `plan_portfolio`, pricing
                a blended portfolio as per-model silos vs a
                consolidated flagship pool vs a routed pool.
  routing.py  — the token-budget-aware router choosing each class's
                cheapest capable model tier off the fitted curves.
  tables.py   — the `planner_tables` JSON payload (embedded in
                `analysis.json` by `experiments.analyze`) + the text
                rendering shared by the CLI and the example.
  __main__.py — the CLI:

    python -m repro_torch.planner --plan paper_atlas --lam 5 --slo-ttft-p90 2000
    python -m repro_torch.planner --plan paper_atlas --portfolio blended_3class

runs from the committed store alone (no engines re-run).
"""
from repro_torch.planner.curves import (  # noqa: F401
    DENSE_MIN_POINTS, DeploymentCurve, curves_by_model, fit_curves,
    penalty_from_util)
from repro_torch.planner.optimize import (  # noqa: F401
    DEFAULT_MAX_REPLICAS, AvailabilityTarget, CapacityPlan,
    DeploymentOption, HeterogeneousMix, MixAllocation, enumerate_options,
    greedy_mix, plan_capacity, rank_options, require_one_model,
    slo_feasible_cap, spares_needed)
from repro_torch.planner.allocate import (  # noqa: F401
    GAP_RTOL, Certificate, ExactMix, certify, exact_mix)
from repro_torch.planner.day import (  # noqa: F401
    curve_lam_cap, day_price_for_curve, day_tables, render_day)
from repro_torch.planner.portfolio import (  # noqa: F401
    ARMS, BLENDED_3CLASS, WORKLOADS, ArmPlan, PoolAllocation,
    PortfolioPlan, Workload, WorkloadClass, plan_portfolio)
from repro_torch.planner.routing import (  # noqa: F401
    RouteDecision, RoutingResult, TierQuote, route_class, route_workload)
from repro_torch.planner.tables import (  # noqa: F401
    PORTFOLIO_LAMS, REFERENCE_LAMS, certification_rows, planner_tables,
    portfolio_row, portfolio_rows, render_certification, render_plan,
    render_plans, render_portfolio)
