"""Port of ``repro/distributed``: the serving mesh
(:mod:`repro_torch.distributed.meshctx`)."""
