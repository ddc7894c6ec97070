"""Fault tolerance: straggler detection, a failure-aware training loop,
elastic restore (port of ``repro.train.ft``).

Runtime-agnostic logic, exercised by simulating failures and stragglers:

  * ``StragglerMonitor`` — per-step wall-time EWMA with outlier flagging.
  * ``run_with_restarts`` — a training loop that resumes from the latest
    atomic checkpoint (``train/checkpoint.py``) after a failure, bitwise:
    the data cursor is the step in the checkpoint, and batches are a pure
    function of the step (``data/pipeline.py``).
  * ``elastic_restore`` — reload a checkpoint onto another mesh.  The port
    drives one device until ``torch.distributed`` lands (ROADMAP §1 item
    6), so the new mesh is a one-device mesh and restoring onto it places
    every tensor leaf on its device; the reference's per-leaf specs come
    with that item.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.launch.mesh import data_devices
from repro_torch.train import checkpoint as ckpt


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time tracker; flags steps slower than ``threshold`` x
    EWMA after ``warmup`` steps (flagged steps do not move the EWMA)."""
    alpha: float = 0.1
    threshold: float = 2.0
    warmup: int = 3
    _ewma: Optional[float] = None
    _n: int = 0
    flagged: List[int] = dataclasses.field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        self._n += 1
        if self._ewma is None:
            self._ewma = dt
            return False
        is_straggler = (self._n > self.warmup
                        and dt > self.threshold * self._ewma)
        if is_straggler:
            self.flagged.append(step)
        else:
            self._ewma = (1 - self.alpha) * self._ewma + self.alpha * dt
        return is_straggler


class SimulatedFailure(RuntimeError):
    pass


def _into(like: Any, restored: Any) -> Any:
    """``restored``'s values written into ``like``'s tensor leaves in place
    (so a model that owns its parameters sees them); ``like`` returned."""
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_into(getattr(like, f), getattr(restored, f))
                            for f in like._fields))
    if isinstance(like, dict):
        return {k: _into(v, restored[k]) for k, v in like.items()}
    if isinstance(like, torch.Tensor):
        with torch.no_grad():
            return like.copy_(restored)
    return restored


def _place(tree: Any, device: torch.device) -> Any:
    """``tree`` (NamedTuples, dicts, tensors) with every tensor on
    ``device`` (the same tensors where they are there already)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_place(getattr(tree, f), device)
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _place(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _mesh_device(mesh) -> torch.device:
    if mesh.size != 1:
        raise NotImplementedError(
            f"restoring onto a {mesh.shape} mesh waits for torch.distributed "
            f"(ROADMAP §1 item 6)")
    return data_devices(mesh)[0]


def restore_into(ckpt_dir: str, step: int, like: Any, mesh=None) -> tuple:
    """Checkpoint ``step`` written into ``like``'s tensors in place (a
    ``TrainState`` built by ``step.init_train_state`` keeps its model's
    parameters), then placed on ``mesh``'s device when given; returns
    ``(tree, extra)``."""
    tree, extra = ckpt.restore(ckpt_dir, step, like)
    tree = _into(like, tree)
    if mesh is not None:
        tree = _place(tree, _mesh_device(mesh))
    return tree, extra


def run_with_restarts(*, make_state: Callable[[], Any],
                      train_step: Callable[[Any, Any], tuple],
                      data_source, n_steps: int, ckpt_dir: str,
                      ckpt_every: int = 10,
                      fail_at: Optional[Dict[int, int]] = None,
                      max_restarts: int = 10,
                      mesh=None) -> Dict[str, Any]:
    """Failure-aware training loop.

    ``fail_at``: {attempt_index: step} — raise ``SimulatedFailure`` at
    ``step`` during that attempt (the test hook; a real failure takes the
    same path).  Each attempt rebuilds the state with ``make_state`` and
    restores the latest checkpoint into its tensors in place (then onto
    ``mesh``'s device when given).  Returns the final
    state, the loss per step, the restart count and the flagged
    stragglers."""
    fail_at = fail_at or {}
    attempt = 0
    monitor = StragglerMonitor()
    losses: Dict[int, float] = {}
    restarts = 0

    while True:
        state = make_state()
        start = 0
        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            state, extra = restore_into(ckpt_dir, last, state, mesh)
            start = extra["next_step"]
        try:
            for step in range(start, n_steps):
                if fail_at.get(attempt) == step:
                    attempt += 1
                    raise SimulatedFailure(f"injected at step {step}")
                batch = data_source.batch_at(step)
                t0 = time.time()
                state, metrics = train_step(state, batch)
                losses[step] = float(metrics["loss"])
                monitor.record(step, time.time() - t0)
                if (step + 1) % ckpt_every == 0 or step + 1 == n_steps:
                    ckpt.save(ckpt_dir, step + 1, state,
                              extra={"next_step": step + 1})
                    ckpt.retain(ckpt_dir, keep=3)
            return {"state": state, "losses": losses, "restarts": restarts,
                    "stragglers": monitor.flagged}
        except SimulatedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise


def elastic_restore(ckpt_dir: str, step: int, like: Any, new_mesh) -> Any:
    """Restore checkpoint ``step`` into ``like``'s tensors, placed on
    ``new_mesh``'s device (a one-device mesh)."""
    return restore_into(ckpt_dir, step, like, new_mesh)[0]
