"""Launchers; mirrors ``repro.launch``.  Ported: ``serve`` and ``train``
(``--local``) and the training step (``steps.build_train_cell``).  The
TPU-mesh lowering (``--dry-run``, ``dryrun``, ``mesh``, ``report``) and the
sharded prefill / decode cells wait for ROADMAP Queue 1 item 4, step 7."""
