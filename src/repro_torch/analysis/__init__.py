"""Static analysis over the port's plan/launch stack.

Two layers, as in the reference (``repro.analysis``):

  * ``analysis.verify`` — proves properties of a launch of the MG3M
    kernels with integer math, no kernel executed: output coverage and
    disjointness of the blocks' walks, the masked-tap predicate, the
    shared-memory budget (and, on a card, the compiled tiles'
    occupancy), dtypes, agreement with the cost model's grid steps and
    MACs.
  * ``analysis.lint`` — AST checks for codebase invariants (no ``assert``
    on public API paths, metric naming, hot-path allocation discipline,
    broad exception hygiene).

``analysis.footprint`` holds the single shared-memory formula shared by
selection, tuning, the kernels and the verifier.

This ``__init__`` stays lazy beyond ``footprint``: ``core.mapping``
imports the footprint at module level, and eagerly importing ``verify``
here (which imports ``core.mapping`` back) would make that a cycle.
"""
from __future__ import annotations

from repro_torch.analysis.footprint import vmem_bytes

__all__ = [
    "vmem_bytes",
    # lazy (see __getattr__): verify-layer API
    "Finding", "verify_plan", "verify_sharded_plan", "verify_choice",
    "verify_point", "sweep_scene", "sweep_scenes",
    # lazy: lint-layer API
    "LintFinding", "lint_paths", "lint_source",
]

_VERIFY_NAMES = ("Finding", "verify_plan", "verify_sharded_plan",
                 "verify_choice", "verify_point", "sweep_scene",
                 "sweep_scenes")
_LINT_NAMES = ("LintFinding", "lint_paths", "lint_source")


def __getattr__(name: str):
    if name in _VERIFY_NAMES:
        from repro_torch.analysis import verify
        return getattr(verify, name)
    if name in _LINT_NAMES:
        from repro_torch.analysis import lint
        return getattr(lint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
