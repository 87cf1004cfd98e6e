"""Entry hooks — counterpart of __graft_entry__.py: the single-device
forward step of the flagship model and the multi-device dry run."""
from __future__ import annotations

import os
import subprocess
import sys


def entry(device="cuda"):
    """(fn, example_args): the forward step of the flagship model — the CTC
    text-line recognizer that powers the OCR path — at full width, from
    flax's initialisers (seed 0), on ``device``: ``fn(*example_args)`` gives
    (8, 96, classes) logits."""
    import torch

    from synapta_tpu_torch.device import resolve_device
    from synapta_tpu_torch.models.recognizer import params_from_flax
    from synapta_tpu_torch.models.train import (
        compute_dtype,
        create_model,
        init_params,
    )

    dev = resolve_device(device)
    model = create_model(compute_dtype(dev))
    model.load_state_dict(params_from_flax(
        init_params(torch.Generator().manual_seed(0))))
    model.to(dev).eval()

    @torch.no_grad()
    def forward(model, imgs):
        return model(imgs)

    imgs = torch.zeros((8, 1, 32, 384), dtype=torch.float32, device=dev)
    return forward, (model, imgs)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run the full multi-device dry run (sharded pipeline step + dp x tp
    train step, synapta_tpu_torch/parallel/dryrun.py) on n shards and n
    ranks, in a FRESH interpreter: the ranks are spawned processes, and the
    caller may hold a process group or a CUDA context of its own."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    # append (never clobber) PYTHONPATH so the repo package resolves
    env["PYTHONPATH"] = repo + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
    )
    proc = subprocess.run(
        [sys.executable, "-m", "synapta_tpu_torch.parallel.dryrun",
         str(n_devices), "--device", str(device)],
        env=env,
        cwd=repo,
        capture_output=True,
        text=True,
        timeout=1800,
    )
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"multi-device dryrun subprocess failed (rc={proc.returncode}); "
            f"stderr tail: {proc.stderr[-2000:]}"
        )
