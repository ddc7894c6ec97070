"""repro_torch.train — plan-driven CNN training: the AdamW optimizer, the
training step over ``ModelPlans`` and checkpoints."""
