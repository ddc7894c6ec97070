"""repro_torch.tune — empirical autotuning with a persistent schedule cache
(port of ``repro.tune``).

Turns schedule selection from a static cost formula into a measured,
cached decision: enumerate the feasible (grain, blocks, compiled tile)
space (``space``), time the analytically-pruned top-k through the real
plan dispatch on the card (``measure``), persist winners keyed by
canonical scene signature, backend and kernel-source version (``cache``),
resolve ``policy="tuned"`` from that artifact (``autotune.
resolve_schedule``), and fit the measured-vs-predicted pairs into a
calibrated cost model (``calibrate``) that selection uses on cache misses.
"""
from repro_torch.tune.autotune import (TunedChoice, autotune_scene,
                                       resolve_schedule)
from repro_torch.tune.cache import (CODE_VERSION, ScheduleCache,
                                    default_backend, default_cache,
                                    resolve_cache_path, scene_from_signature,
                                    scene_signature, set_default_cache)
from repro_torch.tune.calibrate import (CALIB_VERSION, CalibrationReport,
                                        active_cost_model, fit_calibration,
                                        load_calibration,
                                        resolve_calibration_path,
                                        samples_from_cache, save_calibration,
                                        set_active_cost_model)
from repro_torch.tune.measure import (make_operands, measure_choice,
                                      proxy_scene)
from repro_torch.tune.space import (CandidatePoint, block_candidates,
                                    enumerate_space, ranked_space)

__all__ = [
    "TunedChoice", "autotune_scene", "resolve_schedule",
    "CODE_VERSION", "ScheduleCache", "default_backend",
    "default_cache",
    "resolve_cache_path", "scene_from_signature", "scene_signature",
    "set_default_cache",
    "CALIB_VERSION", "CalibrationReport", "active_cost_model",
    "fit_calibration", "load_calibration", "resolve_calibration_path",
    "samples_from_cache", "save_calibration", "set_active_cost_model",
    "make_operands", "measure_choice", "proxy_scene",
    "CandidatePoint", "block_candidates", "enumerate_space", "ranked_space",
]

