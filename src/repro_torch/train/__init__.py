"""The training substrate; mirrors ``repro.train``: AdamW with global-norm
clipping (``optimizer``), step-atomic checkpoints in the object store
(``checkpoint``) and the resumable loop with its synthetic corpus
(``loop``)."""
