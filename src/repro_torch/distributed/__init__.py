"""Port of ``repro/distributed``: the serving mesh
(:mod:`repro_torch.distributed.meshctx`) and the training plan's knobs
(:mod:`repro_torch.distributed.sharding`, ``ExecutionPlan`` only).
``compat.py`` has no counterpart: it bridges two JAX versions."""
