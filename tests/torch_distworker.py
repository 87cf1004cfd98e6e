"""Rank workloads for tests/test_torch_parallel.py, started by
synapta_tpu_torch.parallel.launch.run_ranks (the counterpart of
tests/distworker.py). Spawned processes import this module, so it imports
neither jax nor the JAX package: weights arrive as a flax-layout tree of
numpy arrays, batches as numpy arrays.
"""
import numpy as np
import torch
import torch.distributed as dist

from synapta_tpu_torch.models import optim
from synapta_tpu_torch.models import recognizer as trec
from synapta_tpu_torch.parallel import mesh as M

SCHED = (0.0, 1e-3, 2, 10)  # warmup 2 of 10: the second step moves the weights


def build(tree, width):
    """The float32 recognizer of a flax tree (its dim and depth)."""
    dim = tree["pos_embed"].shape[-1]
    blocks = sum(k.startswith("EncoderBlock_") for k in tree)
    model = trec.Recognizer(dim=dim, blocks=blocks, seq_len=width // 4,
                            dtype=torch.float32)
    model.load_state_dict(trec.params_from_flax(tree))
    return model.train()


def adamw(model):
    return optim.adamw(model.parameters(),
                       optim.warmup_cosine_decay_schedule(*SCHED), 0.9, 0.98)


def steps_workload(rank, world, coordinator, model_axis, tree, batches,
                   backend="gloo", device="cpu"):
    """Join ``world`` ranks (gloo on the CPU unless named otherwise), lay
    them out data x model, cut the model over 'model', run the sharded
    forward on the first batch's images and one dp x tp step per batch.
    Returns what every rank must agree on: mesh shape, logits, losses, the
    gathered parameters (flax layout) and the names of the kernels this rank
    holds a part of."""
    torch.set_num_threads(2)  # several ranks share the host's cores
    assert M.init_distributed(coordinator, world, rank, backend, device) is True
    try:
        mesh = M.make_mesh(world, model_axis=model_axis, device=device)
        width = batches[0][0].shape[2]
        model = M.shard_params(build(tree, width).to(device), mesh)
        cut = sorted(n for n, p in model.named_parameters()
                     if getattr(p, "sharded", False))
        x = torch.from_numpy(batches[0][0]).permute(0, 3, 1, 2).to(device)
        logits = M.make_inference_fn(model, mesh)(x).cpu().numpy()
        step = M.make_dp_tp_train_step(model, adamw(model), mesh)
        losses = [float(step(*b)) for b in batches]
        params = trec.params_to_flax(M.unshard_params(model, mesh))
        return {"mesh": M.mesh_shape(mesh), "logits": logits, "losses": losses,
                "params": params, "cut": cut, "rank": dist.get_rank()}
    finally:
        dist.destroy_process_group()


def failing_rank(rank, world, coordinator):
    """Rank 1 raises; the others return their rank."""
    if rank == 1:
        raise ValueError("rank 1 gives up")
    return rank
