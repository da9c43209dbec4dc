"""Launchers; mirrors ``repro.launch``: ``serve`` and ``train`` (``--local``
and ``--dry-run``), ``steps`` (the train, prefill and decode cells on a
mesh, and the one-device training step), ``mesh``, ``dryrun`` (every cell's
per-device cost and memory on a fake 256- or 512-rank world at H100
constants) and ``report`` (its tables)."""
