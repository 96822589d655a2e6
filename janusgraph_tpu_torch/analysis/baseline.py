"""Suppression ratchet: a checked-in budget that only goes down.

``# graphlint: disable=JGnnn -- why`` keeps the tree lint-clean without
pretending a finding doesn't exist — but suppressions rot: each one is a
permanent exemption nobody revisits. The ratchet makes the *count* a
tracked artifact:

- ``--write-baseline .graphlint-baseline.json`` records today's per-rule
  suppression counts (sorted keys, newline-terminated — byte-stable for
  review diffs).
- ``--baseline .graphlint-baseline.json`` (CI mode) fails the run when
  any rule's suppression count EXCEEDS its recorded budget — new code
  must fix findings, not silence them. Counts below budget are reported
  as tighten opportunities; re-run ``--write-baseline`` to bank them.
- ``--report-suppressions`` prints the budget table (rule, used, budget,
  headroom) for humans.

Stdlib-only, like the rest of the analyzer.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

SCHEMA_VERSION = 1


def write_baseline(path: str, suppressions_by_rule: Dict[str, int]) -> dict:
    """Persist per-rule suppression budgets; returns the written payload."""
    payload = {
        "schema_version": SCHEMA_VERSION,
        "tool": "graphlint-baseline",
        "suppressions": {
            rule: int(n) for rule, n in sorted(suppressions_by_rule.items())
            if n
        },
    }
    payload["total"] = sum(payload["suppressions"].values())
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    return payload


def load_baseline(path: str) -> Dict[str, int]:
    """The per-rule budget map from a baseline file (raises on a file
    that isn't a graphlint baseline — failing loud beats ratcheting
    against garbage)."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if data.get("tool") != "graphlint-baseline":
        raise ValueError(f"{path} is not a graphlint baseline file")
    return {str(k): int(v) for k, v in data.get("suppressions", {}).items()}


def compare(
    suppressions_by_rule: Dict[str, int], budget: Dict[str, int]
) -> Tuple[List[Tuple[str, int, int]], List[Tuple[str, int, int]]]:
    """(regressions, improvements) as (rule, used, budget) triples.

    A rule absent from the baseline has budget 0: brand-new suppressions
    always regress until a human re-banks the baseline.
    """
    regressions, improvements = [], []
    for rule in sorted(set(suppressions_by_rule) | set(budget)):
        used = suppressions_by_rule.get(rule, 0)
        allowed = budget.get(rule, 0)
        if used > allowed:
            regressions.append((rule, used, allowed))
        elif used < allowed:
            improvements.append((rule, used, allowed))
    return regressions, improvements


def report_table(
    suppressions_by_rule: Dict[str, int],
    budget: Optional[Dict[str, int]] = None,
) -> str:
    """Human-readable budget table. Without a baseline the budget column
    mirrors usage (informational)."""
    rules = sorted(set(suppressions_by_rule) | set(budget or {}))
    lines = ["suppression budget:", "  rule    used  budget  headroom"]
    total_used = total_budget = 0
    for rule in rules:
        used = suppressions_by_rule.get(rule, 0)
        allowed = budget.get(rule, used) if budget is not None else used
        total_used += used
        total_budget += allowed
        lines.append(
            f"  {rule:<7} {used:>4}  {allowed:>6}  {allowed - used:>+8}"
        )
    if not rules:
        lines.append("  (no suppressions)")
    lines.append(
        f"  total   {total_used:>4}  {total_budget:>6}"
        f"  {total_budget - total_used:>+8}"
    )
    return "\n".join(lines)
