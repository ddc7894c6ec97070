"""repro_torch.tune — the selector's search space and the schedule-choice
(de)serializers.  Measurement, autotuning and calibration are a later
slice."""
