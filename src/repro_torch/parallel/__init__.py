"""repro_torch.parallel — activation-sharding hooks and the logical-axis
sharding rules, at one device (port of ``repro.parallel``)."""
