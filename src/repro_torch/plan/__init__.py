"""repro_torch.plan — plan-once / execute-many convolution operator API
(port of ``repro.plan``).

``make_plan(scene, op, policy=..., device=...)`` runs schedule resolution
exactly once, derives the backward scenes for DGRAD/WGRAD through the same
selector, and precomputes every padded/aligned shape into a frozen
``ConvPlan``; ``plan.execute(a, b)`` then only dispatches.
``PlanRegistry`` keeps a process-level, LRU-bounded, JSON-serializable
repository of plans so serving can warm-start.
"""
from repro_torch.plan.build import (ConvOp, ConvPlan, ExecSpec,
                                    assemble_plan, derive_exec_spec,
                                    grad_filter_scene, grad_input_scene,
                                    make_plan, policy_tag, resolve_policy)
from repro_torch.plan.registry import (PLAN_VERSION, PlanRegistry,
                                       default_registry, get_plan,
                                       plan_from_dict, plan_signature,
                                       plan_to_dict, set_default_registry)

__all__ = [
    "ConvOp", "ConvPlan", "ExecSpec", "assemble_plan", "derive_exec_spec",
    "grad_filter_scene", "grad_input_scene", "make_plan", "policy_tag",
    "resolve_policy",
    "PLAN_VERSION", "PlanRegistry", "default_registry", "get_plan",
    "plan_from_dict", "plan_signature", "plan_to_dict",
    "set_default_registry",
]
