"""repro_torch.serve — scene-bucketed conv serving and the latency-aware
whole-model scheduler (port of ``repro.serve.conv`` and
``repro.serve.sched``)."""
