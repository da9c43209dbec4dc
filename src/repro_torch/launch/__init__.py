"""Launchers; mirrors ``repro.launch``.  Ported: ``serve`` (``--local``).
Training launchers and the TPU-mesh lowering (``--dry-run``) wait for
ROADMAP Queue 1 item 4, steps 6 and 7."""
