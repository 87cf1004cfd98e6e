"""Recognizer training: CTC on synthetic text lines — counterpart of
synapta_tpu/models/train.py.

Run:  python -m synapta_tpu_torch.models.train --device cuda --steps 1500

The model trains in float32 parameters with a bfloat16 compute dtype on the
GPU, as flax does (``Recognizer(param_dtype=torch.float32)``; float32 compute
on the CPU), from flax's
initialisers or from a checkpoint (``--init-from``, padded across a charset
extension). The CTC loss is ``F.ctc_loss`` on float32 log-probabilities,
averaged per sequence as optax's is; the optimiser is ``optim.adamw`` over a
100-step warmup and a cosine decay. A step leaves its loss on the device; the
host reads it back only every ``log_every`` steps. Checkpoints are flax
msgpack files (float32, flax's layout) that the JAX package's
``load_params`` reads; they go under ``synapta_tpu_torch/_build/weights/``
unless ``--out`` names another path.

``--mesh`` is data parallelism over a rank mesh, one process per device:
start the same command once per device with SYNAPTA_COORDINATOR
("host:port"), SYNAPTA_NUM_PROCESSES and SYNAPTA_PROCESS_ID set
(parallel/mesh.py::init_distributed; NCCL on CUDA, gloo on the CPU). Every
rank draws the same global batch from the same seed and takes its slice, the
gradients are averaged over the ranks, and rank 0 alone logs, evaluates and
saves. Without a coordinator ``--mesh`` is the single-process run.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from synapta_tpu_torch.device import resolve_device
from synapta_tpu_torch.models.charset import BLANK, decode_greedy
from synapta_tpu_torch.models.msgpack_io import (  # noqa: F401 (load_params)
    load_params,
    msgpack_restore,
    write_params,
)
from synapta_tpu_torch.models.recognizer import (
    Recognizer,
    params_from_flax,
    params_to_flax,
)
from synapta_tpu_torch.models.recognizer import init_params as _flax_init
from synapta_tpu_torch.models.synthdata import make_batch

# Where the port's trainer writes (git-ignored). The shipped weights under
# synapta_tpu/models/weights/ are read (``load_params``), never written.
WEIGHTS_OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "_build", "weights", "recognizer.msgpack",
)


def compute_dtype(dev: torch.device) -> torch.dtype:
    """The trainers' compute dtype: bfloat16 on the GPU, as the JAX package
    trains; float32 on the CPU, where torch's bfloat16 convs run several
    times slower than its float32 ones."""
    return torch.bfloat16 if dev.type == "cuda" else torch.float32


def create_model(dtype: torch.dtype = torch.bfloat16) -> Recognizer:
    """The recognizer as the JAX package trains it: bfloat16 compute,
    float32 parameters."""
    return Recognizer(dtype=dtype, param_dtype=torch.float32)


def init_params(generator: torch.Generator, height=32, width=384) -> Dict:
    """A fresh parameter tree in flax's layout (float32 numpy), drawn from
    flax's initialisers with ``generator``."""
    model = Recognizer(seq_len=width // 4, dtype=torch.float32)
    return params_to_flax(_flax_init(model, generator).state_dict())


def ctc_objective(model, imgs, labels, label_lens) -> torch.Tensor:
    """Mean CTC loss of ``model`` on (B, 1, H, W) images against padded
    (B, L) labels: optax's per-sequence negative log-likelihood (every frame
    valid, blank 0) averaged over the batch. ``reduction="mean"`` would
    divide each sequence by its label length first."""
    logits = model(imgs)  # (B, T, C)
    B, T, _ = logits.shape
    log_probs = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    frames = torch.full((B,), T, dtype=torch.long, device=logits.device)
    loss = F.ctc_loss(log_probs, labels.long(), frames, label_lens.long(),
                      blank=BLANK, reduction="none", zero_infinity=False)
    return loss.mean()


def make_step(model, tx, objective, mesh=None):
    """Returns step(imgs, *targets) -> loss: one update of ``model``'s
    parameters by ``tx`` (``optim.adamw``) on ``objective(model, images,
    *targets)``, from a host batch (numpy; images (B, H, W, 1)). The loss
    stays a 0-dim tensor on the model's device.

    With a rank mesh (parallel/mesh.py::make_mesh) the batch is the GLOBAL
    one, the same on every rank: each rank takes its slice along 'data', and
    the gradients and the loss are averaged over the ranks before the
    update."""
    dev = model.head.weight.device
    if mesh is not None:
        from synapta_tpu_torch.parallel.mesh import reduce_gradients, shard_batch

    def step(imgs, *targets):
        if mesh is not None:
            imgs, *targets = shard_batch((imgs, *targets), mesh)
        x = torch.from_numpy(imgs).to(dev).permute(0, 3, 1, 2)
        t = [torch.from_numpy(a).to(dev) for a in targets]
        tx.opt.zero_grad(set_to_none=True)
        loss = objective(model, x, *t)
        loss.backward()
        if mesh is not None:
            loss = reduce_gradients(list(model.parameters()), loss, mesh)
        tx.step()
        return loss.detach()

    return step


def make_train_step(model, tx, mesh=None):
    """step(imgs, labels, label_lens) -> loss on a ``make_batch`` batch.
    With a mesh: the batch sharded on 'data', the parameters replicated,
    the gradients averaged over the ranks."""
    return make_step(model, tx, ctc_objective, mesh)


@torch.inference_mode()
def greedy_decode(model, imgs):
    """(B, H, W, 1) host images -> (best class, its probability) per frame,
    (B, T) numpy each."""
    dev = model.head.weight.device
    logits = model(torch.from_numpy(imgs).to(dev).permute(0, 3, 1, 2))
    best = torch.argmax(logits, dim=-1)
    conf = torch.softmax(logits, dim=-1).amax(dim=-1)
    return best.cpu().numpy(), conf.cpu().numpy()


def cer(ref: str, hyp: str) -> float:
    """Levenshtein character error rate."""
    if not ref:
        return 0.0 if not hyp else 1.0
    m, n = len(ref), len(hyp)
    dp = list(range(n + 1))
    for i in range(1, m + 1):
        prev = dp[0]
        dp[0] = i
        for j in range(1, n + 1):
            cur = dp[j]
            dp[j] = min(
                dp[j] + 1, dp[j - 1] + 1, prev + (ref[i - 1] != hyp[j - 1])
            )
            prev = cur
    return dp[n] / m


def evaluate(model, rng, n_batches=4, batch=64) -> float:
    """Mean CER of greedy decoding over ``n_batches`` synthetic batches."""
    from synapta_tpu_torch.models import charset

    total = 0.0
    count = 0
    for _ in range(n_batches):
        imgs, labels, lens = make_batch(rng, batch=batch)
        best, _ = greedy_decode(model, imgs)
        for i in range(batch):
            ref = "".join(
                charset.ID_TO_CHAR.get(int(c), "") for c in labels[i][: lens[i]]
            )
            hyp = decode_greedy(best[i])
            total += cer(ref, hyp)
            count += 1
    return total / max(count, 1)


def pad_params(old_params, new_params):
    """Warm-start across an APPEND-ONLY charset extension: every leaf of
    the old checkpoint is copied into the freshly initialized tree; leaves
    whose shapes grew (the CTC head's Dense kernel/bias gaining classes)
    are copied into the overlapping slice, leaving fresh init in the new
    tail. Valid only because charset extension preserves old class ids."""
    def merge(old, new, path):
        if isinstance(new, dict):
            old = old if isinstance(old, dict) else {}
            return {k: merge(old.get(k), v, path + (k,)) for k, v in new.items()}
        if old is None or old.shape == new.shape:
            return np.asarray(old) if old is not None else new
        if len(old.shape) != len(new.shape):
            raise ValueError(f"rank mismatch at {path}")
        merged = np.array(new)
        sl = tuple(slice(0, min(a, b)) for a, b in zip(old.shape, new.shape))
        merged[sl] = np.asarray(old)[sl]
        return merged

    return merge(old_params, new_params, ())


def save_params(params, path: str = WEIGHTS_OUT) -> None:
    """Write a parameter tree (flax layout) as a flax msgpack file."""
    write_params(params, path)


def run_steps(step_fn, gen, rng, steps: int, log_every: int, dev, save) -> Dict:
    """The trainers' loop: draw a batch on the host (``gen(rng)``), enqueue
    a step, read the loss back only every ``log_every`` steps (then
    ``save()``). Returns the per-step losses and the wall, host data, host
    step and (on CUDA) device step seconds: the CUDA-event span of each
    step's work, summed."""
    losses = torch.empty(steps, device=dev)
    spans = []
    data_s = host_step_s = 0.0
    t0 = time.time()
    for s in range(steps):
        t = time.perf_counter()
        batch = gen(rng)
        data_s += time.perf_counter() - t
        t = time.perf_counter()
        if dev.type == "cuda":
            spans.append((torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True)))
            spans[-1][0].record()
        losses[s] = step_fn(*batch)
        if dev.type == "cuda":
            spans[-1][1].record()
        host_step_s += time.perf_counter() - t
        if (s + 1) % log_every == 0:
            print(
                f"step {s + 1}/{steps} loss {float(losses[s]):.4f} "
                f"({(time.time() - t0) / (s + 1):.3f}s/step)",
                flush=True,
            )
            save()
    losses = losses.tolist()  # waits for the last step
    return {"steps": steps, "losses": losses, "wall_s": time.time() - t0,
            "data_s": data_s, "host_step_s": host_step_s,
            "device_step_s": (sum(a.elapsed_time(b) for a, b in spans) / 1e3
                              if spans else None)}


def train(
    steps: int = 1500,
    batch: int = 64,
    lr: float = 3e-4,
    seed: int = 0,
    out: str = WEIGHTS_OUT,
    use_mesh: bool = False,
    log_every: int = 100,
    init_from: str | None = None,
    data: str = "pil",
    shot_frac: float = 0.16,
    device="cuda",
) -> Dict:
    """Train on ``device`` (``"cuda"`` raises without a GPU; the compute
    dtype follows it, ``compute_dtype``) with adamw (b2
    0.98) over a 100-step warmup and a cosine decay to ``steps`` (optax
    raises when steps <= 100, and so does this); evaluate the CER on 256
    fresh lines; write the float32 parameters to ``out`` every
    ``log_every`` steps and at the end. Returns the run: the trained model,
    the CER, per-step losses, and the wall, host data, host step and device
    step seconds.

    ``use_mesh``: data parallelism over every rank of the process group that
    ``init_distributed`` joins from its env vars (none configured: the
    single-process run). ``batch`` stays the global batch; rank 0 alone
    logs, evaluates (``cer`` is None elsewhere) and saves."""
    import torch.distributed as dist

    from synapta_tpu_torch.hostlibs import ensure_synthdata_fonts
    from synapta_tpu_torch.models.optim import adamw, warmup_cosine_decay_schedule
    from synapta_tpu_torch.parallel.mesh import init_distributed, make_mesh

    dev = resolve_device(device)
    joined = use_mesh and init_distributed(device=dev)
    try:
        mesh = make_mesh(device=dev) if joined else None
        rank0 = mesh is None or mesh.get_rank() == 0
        ensure_synthdata_fonts()
        gen = torch.Generator().manual_seed(seed)
        if init_from:
            # template-free restore: the checkpoint may predate a charset
            # extension, so its head is narrower than the current model's —
            # pad_params copies it into a fresh init (append-only class ids)
            with open(init_from, "rb") as f:
                raw = msgpack_restore(f.read())
            params = pad_params(raw, init_params(gen))
        else:
            params = init_params(gen)
        model = create_model(compute_dtype(dev))
        model.load_state_dict(params_from_flax(params))
        model.to(dev).train()
        tx = adamw(model.parameters(),
                   warmup_cosine_decay_schedule(0.0, lr, 100, steps), 0.9, 0.98)
        step_fn = make_train_step(model, tx, mesh)
        if data == "mixed":
            from synapta_tpu_torch.models.synthdata import make_batch_mixed

            def batches(r):
                return make_batch_mixed(r, batch=batch, shot_frac=shot_frac)
        else:
            def batches(r):
                return make_batch(r, batch=batch, shot_frac=shot_frac)

        def save():
            save_params(params_to_flax(model.state_dict()), out)

        # a rank other than 0 never reaches a log step: no print, no save
        run = run_steps(step_fn, batches, np.random.default_rng(seed), steps,
                        log_every if rank0 else steps + 1, dev, save)
        run["model"] = model.eval()
        run["cer"] = None
        if rank0:
            run["cer"] = evaluate(model, np.random.default_rng(seed + 1))
            print(f"eval CER: {run['cer']:.4f}")
            save()
            print(f"saved -> {out}")
        return run
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=WEIGHTS_OUT)
    ap.add_argument("--mesh", action="store_true",
                    help="data parallelism over the ranks named by "
                         "SYNAPTA_COORDINATOR, SYNAPTA_NUM_PROCESSES and "
                         "SYNAPTA_PROCESS_ID (one process per device)")
    ap.add_argument("--init-from", default=None)
    ap.add_argument("--data", default="pil", choices=["pil", "mixed"])
    ap.add_argument("--shot-frac", type=float, default=0.16)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args()
    if args.data == "mixed":
        # half of a mixed batch is drawn by the native PDF engine, which
        # needs libjpeg.so.62; re-exec with Pillow's copy where it is missing
        from synapta_tpu_torch.hostlibs import ensure_native_engine

        ensure_native_engine(["-m", "synapta_tpu_torch.models.train",
                              *sys.argv[1:]])
    train(args.steps, args.batch, args.lr, args.seed, args.out, args.mesh,
          init_from=args.init_from, data=args.data, shot_frac=args.shot_frac,
          device=args.device)
