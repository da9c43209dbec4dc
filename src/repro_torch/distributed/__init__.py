"""Distributed execution on ``torch.distributed``; mirrors
``repro.distributed``.  Where the reference takes a device mesh and lets
GSPMD place the collectives, these take a ``DeviceMesh`` (or a process
group) and every rank runs the same code on its local shards, with the
collectives explicit.

``partition`` (parameter, batch and cache specs, local shards),
``act_sharding`` (the policy the model code reads, its collectives and
their tally), ``search`` (segment-parallel top-k with a two-phase reduce,
and ``dryrun_search``) and ``decode_attn`` (flash decode over
sequence-sharded caches).
"""
