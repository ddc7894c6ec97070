"""repro_torch.train — training: the AdamW optimizer, checkpoints, the
plan-driven CNN step over ``ModelPlans`` (``cnn``), the LM step
(``step``) and fault tolerance (``ft``)."""
