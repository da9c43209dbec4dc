"""Training launcher; mirrors ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --shape train_4k --dry-run
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --local --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --local --device cpu

``--local`` trains the architecture's reduced configuration for real
(``train.loop.train``: the synthetic corpus, AdamW, a checkpoint every 25
steps and at the end into a ``FileObjectStore`` under ``--ckpt-dir``,
resuming from the newest one there).  It runs on the card unless
``--device cpu`` is given, and raises when no GPU is visible.
``--dry-run`` runs ``launch.dryrun.run_cell`` for ``--arch``, ``--shape``
and ``--multi-pod`` (the train cell on the production mesh, on the CPU,
in a fake world) and prints its memory and roofline terms.
"""

from __future__ import annotations

import argparse
import time

from .serve import dry_run


def main(argv: list[str] | None = None) -> list[float] | dict | None:
    """Parse ``argv`` (the command line when None) and run.  ``--local``
    returns the loss of every step it ran, ``--dry-run`` the dry-run's
    result."""
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--local", action="store_true",
                    help="train a reduced config for real on this device")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", default="repro_train_ckpts")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.dry_run:
        return dry_run(args.arch, args.shape, args.multi_pod)
    if not args.local:
        ap.error("choose --dry-run or --local")

    from .._device import resolve_device
    from ..configs import get_arch
    from ..core.object_store import FileObjectStore
    from ..train.loop import TrainConfig, train

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch).reduced()
    store = FileObjectStore(args.ckpt_dir)
    tc = TrainConfig(steps=args.steps, run_name=f"local-{args.arch}")
    t0 = time.time()
    _model, _opt, losses = train(cfg, store, tc, device=dev)
    if losses:
        print(f"{args.arch}-reduced: {len(losses)} steps in {time.time() - t0:.1f}s on {dev}; "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    else:
        print(f"{args.arch}-reduced: already trained to step {args.steps} in {args.ckpt_dir}")
    return losses


if __name__ == "__main__":
    main()
