"""Schedule-choice (de)serialization (the part of ``repro.tune.cache``
the plan registry needs; the tune cache itself is a later slice)."""
from __future__ import annotations

from typing import Dict

from repro_torch.core.mapping import ScheduleChoice


def choice_to_dict(choice: ScheduleChoice) -> Dict:
    return {
        "schedule": choice.schedule, "bm": choice.bm, "bn": choice.bn,
        "bk": choice.bk, "predicted_s": choice.predicted_s,
        "compute_s": choice.compute_s, "hbm_s": choice.hbm_s,
        "vmem_bytes": choice.vmem_bytes, "notes": choice.notes,
        "tile": list(choice.tile),
    }


def choice_from_dict(d: Dict) -> ScheduleChoice:
    return ScheduleChoice(
        schedule=d["schedule"], bm=int(d["bm"]), bn=int(d["bn"]),
        bk=int(d["bk"]), predicted_s=float(d["predicted_s"]),
        compute_s=float(d["compute_s"]), hbm_s=float(d["hbm_s"]),
        vmem_bytes=int(d["vmem_bytes"]), notes=d.get("notes", ""),
        tile=tuple(int(t) for t in d.get("tile", ())),
    )
