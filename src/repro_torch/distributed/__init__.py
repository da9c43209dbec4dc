"""Distributed execution on ``torch.distributed``; mirrors
``repro.distributed``.  Where the reference takes a device mesh and runs a
``shard_map``, these take a process group: every rank runs the same code
on its shard, and collectives join the ranks.

Ported: ``search`` (segment-parallel top-k with a two-phase reduce),
``decode_attn`` (flash decode over sequence-sharded caches) and
``act_sharding.policy`` (the scope that switches ``models.moe`` to expert
parallelism).  ``partition`` (parameter and cache shardings), the rest of
``act_sharding`` and ``search.dryrun_search`` lower onto TPU meshes and
wait for ROADMAP Queue 1 item 4, step 7.
"""
