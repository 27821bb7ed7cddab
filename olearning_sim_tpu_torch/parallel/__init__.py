"""Sequence parallelism over ``torch.distributed``: process meshes
(:mod:`.mesh`), ring attention (:mod:`.ring_attention`) and the
long-context entry points (:mod:`.long_context`)."""
