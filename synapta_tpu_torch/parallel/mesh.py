"""Device-mesh parallelism — counterpart of synapta_tpu/parallel/mesh.py.

JAX runs everything on one single-process ``Mesh`` and lets XLA insert the
collectives. PyTorch has no such thing, so the port uses the idiom that fits
each path and keeps the JAX package's names:

1. Inference (the pipeline): ONE process, N devices. ``data_mesh`` returns a
   ``DataMesh``, an ordered list of shards, each a ``torch.device`` with a
   stream of its own. ``DataMesh.dispatch`` splits a fixed-shape host chunk
   evenly along the batch, copies shard i to its device (pinned source,
   ``non_blocking``) and enqueues the function there on shard i's stream;
   nothing waits until ``Sharded.cpu()`` brings the shards back, in shard
   order, into one host tensor.
2. Training: one process PER device and ``torch.distributed``.
   ``init_distributed`` joins the ranks, ``make_mesh`` lays them out as a
   ("data", "model") ``DeviceMesh``, ``shard_params`` cuts the wide kernels
   over 'model', and ``make_dp_tp_train_step`` is the CTC step with the batch
   on 'data'. The collectives are written out (``all_reduce``,
   ``all_gather``: the two that both NCCL and gloo have).

Axes:
  data  — batch dimension (pages, crops, text lines)
  model — TP shards of large dense kernels
"""
from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from synapta_tpu_torch.device import resolve_device


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device="cuda") -> bool:
    """Multi-process initialization: one process per device.

    Call ONCE in each process before any collective. Parameters come from
    arguments or the env vars SYNAPTA_COORDINATOR ("host:port") /
    SYNAPTA_NUM_PROCESSES / SYNAPTA_PROCESS_ID. ``backend`` defaults to
    "nccl" for a CUDA ``device`` and "gloo" for the CPU. On CUDA without a
    device index, rank r takes GPU ``r % torch.cuda.device_count()``.

    Returns True when a process group was initialized (the caller destroys
    it: ``torch.distributed.destroy_process_group()``), False with no side
    effect for the single-process case (no coordinator configured and
    num_processes None or 1).
    """
    coordinator = coordinator or os.environ.get("SYNAPTA_COORDINATOR")
    if num_processes is None:
        env = os.environ.get("SYNAPTA_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("SYNAPTA_PROCESS_ID")
        process_id = int(env) if env else None
    if not coordinator and num_processes in (None, 1):
        return False  # single-process: nothing to do
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and dev.index is None:
        torch.cuda.set_device((process_id or 0) % torch.cuda.device_count())
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator}",
        world_size=num_processes,
        rank=process_id,
    )
    return True


# ------------------------------------------------------------ inference mesh


@dataclass(frozen=True)
class DataMesh:
    """A 1-D ('data',) mesh of one process: shard i of a batch runs on
    ``devices[i]``, on ``streams[i]`` (None: the device's current stream, as
    on the CPU and on a mesh of one)."""

    devices: Tuple[torch.device, ...]
    streams: Tuple[Optional[Any], ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {"data": self.size}

    def stream(self, i: int):
        """Context manager that makes shard i's stream the current one."""
        if self.streams[i] is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.streams[i])

    def dispatch(self, fn: Callable[..., torch.Tensor], *arrays) -> "Sharded":
        """Split each host array (numpy, batch first) evenly over the shards
        and enqueue ``fn(*shard tensors)`` on every shard's device and stream
        without waiting for any of it. A shard's stream is ordered after
        what its device's current stream holds at this moment (the weights
        ``fn`` reads may still be on their way)."""
        n = self.size
        B = arrays[0].shape[0]
        if B % n:
            raise ValueError(f"batch {B} does not split over {n} data shards")
        per = B // n
        parts = []
        for i, dev in enumerate(self.devices):
            if self.streams[i] is not None:
                self.streams[i].wait_stream(torch.cuda.current_stream(dev))
            with self.stream(i):
                shard = []
                for a in arrays:
                    t = torch.from_numpy(
                        np.ascontiguousarray(a[i * per:(i + 1) * per]))
                    if dev.type == "cuda":
                        t = t.pin_memory()
                    shard.append(t.to(dev, non_blocking=True))
                parts.append(fn(*shard))
        return Sharded(tuple(parts), self)


@dataclass(frozen=True)
class Sharded:
    """The per-shard results of ``DataMesh.dispatch``, still on their
    devices. ``cpu()`` is the one place that waits."""

    parts: Tuple[torch.Tensor, ...]
    mesh: DataMesh

    def cpu(self) -> torch.Tensor:
        """One host tensor, shards in order; each shard's copy is ordered
        after that shard's work on that shard's stream."""
        out = []
        for i, p in enumerate(self.parts):
            with self.mesh.stream(i):
                out.append(p.cpu())
        return torch.cat(out)


def _available(dev: torch.device) -> int:
    """Real devices a data mesh on ``dev`` can use: every GPU for "cuda",
    the named one for "cuda:N", one for the CPU."""
    if dev.type == "cuda" and dev.index is None:
        return torch.cuda.device_count()
    return 1


def data_mesh(n_devices: Optional[int] = None, device="cuda",
              virtual: bool = False) -> DataMesh:
    """A 1-D ('data',) mesh of n shards — the inference-path mesh for
    page/crop-batch data parallelism. On CUDA, asking for more shards than
    there are GPUs raises unless ``virtual``, which places the extra shards
    on the GPUs there are, round robin (the counterpart of XLA's forced host
    device count). Every shard of a CUDA mesh of more than one has a stream
    of its own. A CPU mesh is always virtual: its shards run in turn."""
    dev = resolve_device(device)
    avail = _available(dev)
    n = n_devices or avail
    if dev.type == "cpu":
        return DataMesh((dev,) * n, (None,) * n)
    if n > avail and not virtual:
        raise ValueError(f"requested {n} devices, have {avail}")
    if n == 1:
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        return DataMesh((torch.device("cuda", index),), (None,))
    first = dev.index or 0
    devices = tuple(torch.device("cuda", first + i % avail) for i in range(n))
    return DataMesh(devices, tuple(torch.cuda.Stream(d) for d in devices))


def data_mesh_auto(batch: int, n_devices: Optional[int] = None,
                   device="cuda") -> DataMesh:
    """The largest data mesh whose size divides ``batch`` (fixed-shape
    device chunks must split evenly across the 'data' axis). Never virtual
    on CUDA: more shards than GPUs raises, as in ``data_mesh``."""
    avail = n_devices or _available(resolve_device(device))
    n = max(d for d in range(1, avail + 1) if batch % d == 0)
    return data_mesh(n, device)


# ------------------------------------------------------------- training mesh


def make_mesh(n_devices: Optional[int] = None, model_axis: int = 1,
              device="cuda"):
    """A (data, model) ``DeviceMesh`` over the ranks of the process group
    (``init_distributed`` first). data*model must equal the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or world
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    if n % model_axis:
        raise ValueError(f"{n} devices not divisible by model axis {model_axis}")
    if n < world:
        raise ValueError(f"a rank mesh spans the whole process group: "
                         f"requested {n} devices of {world}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_distributed with a coordinator first")
    return init_device_mesh(resolve_device(device).type,
                            (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))


def mesh_shape(mesh) -> dict:
    """{'data': d, 'model': m} of a rank mesh."""
    return {"data": mesh.size(0), "model": mesh.size(1)}


def param_spec(path: tuple, value: Any, mesh) -> bool:
    """TP rule, stated on the FLAX name and shape of a parameter: 2-D+
    kernels whose output (last) dim divides the model axis shard on 'model'
    (True); everything else replicates (False)."""
    model_size = mesh.size(1)
    name = str(path[-1]) if path else ""
    return (
        model_size > 1
        and hasattr(value, "ndim")
        and value.ndim >= 2
        and "kernel" in name
        and value.shape[-1] % model_size == 0
    )


def sharded_kernels(model, mesh) -> list:
    """The flax paths (tuples) of the kernels ``param_spec`` shards."""
    from synapta_tpu_torch.models.recognizer import params_to_flax

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, path + (k,))
            elif param_spec(path + (k,), v, mesh):
                yield path + (k,)

    return list(walk(params_to_flax(model.state_dict()), ()))


class _Copy(torch.autograd.Function):
    """Identity on a tensor every 'model' rank holds whole, entering a layer
    whose kernel is cut over 'model': each rank's backward sees only its own
    columns' share of the input gradient, so the backward sums the shares."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather of the ranks' output columns along ``dim``. What follows
    is computed alike on every 'model' rank, so the gradient of this rank's
    columns is its slice of the gathered gradient."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.width = dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.width, ctx.width), None, None


@dataclass(frozen=True)
class ModelAxis:
    """What a layer whose kernel is cut over 'model' needs: the axis' process
    group. ``column(fn, x, dim)`` runs ``fn`` (this rank's output columns,
    without the bias) on the whole input and gathers every rank's columns
    along ``dim``, differentiably."""

    group: Any

    def column(self, fn, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _Gather.apply(fn(_Copy.apply(x, self.group)), dim, self.group)


def shard_params(model, mesh):
    """Cut ``model``'s (a Recognizer's) kernels over 'model' in place and
    return it: every kernel ``param_spec`` shards keeps this rank's block of
    output rows (dim 0 of a torch Linear or conv weight, which is flax's last
    dim; for the attention projections whole or part heads), marked
    ``.sharded``; its layer gathers the ranks' output columns before the
    bias, which stays whole like every other parameter. Optimiser state
    follows the parameters: build ``tx`` on the sharded model."""
    from synapta_tpu_torch.models.recognizer import kernel_modules

    group = mesh.get_group("model")
    size, rank = mesh.size(1), mesh.get_local_rank("model")
    modules = kernel_modules(model)
    for path in sharded_kernels(model, mesh):
        layer = modules[path]
        rows = layer.weight.shape[0] // size
        layer.weight = torch.nn.Parameter(
            layer.weight.detach()[rank * rows:(rank + 1) * rows].clone())
        layer.weight.sharded = True
        layer.model_axis = ModelAxis(group)
    return model


def unshard_params(model, mesh) -> dict:
    """The whole model's state_dict from a ``shard_params`` model: every
    sharded kernel gathered over 'model' (a collective: call on every
    rank)."""
    group = mesh.get_group("model")
    out = {}
    for name, p in model.state_dict(keep_vars=True).items():
        t = p.detach()
        if getattr(p, "sharded", False):
            parts = [torch.empty_like(t) for _ in range(mesh.size(1))]
            dist.all_gather(parts, t.contiguous(), group=group)
            t = torch.cat(parts, dim=0)
        out[name] = t.clone()
    return out


def shard_batch(batch, mesh):
    """This rank's slice along 'data' of every array (numpy or tensor,
    batch first) of a global batch."""
    n, i = mesh.size(0), mesh.get_local_rank("data")

    def cut(a):
        if a.shape[0] % n:
            raise ValueError(
                f"batch {a.shape[0]} does not split over {n} data ranks")
        per = a.shape[0] // n
        return a[i * per:(i + 1) * per]

    if isinstance(batch, (tuple, list)):
        return type(batch)(cut(a) for a in batch)
    return cut(batch)


def make_inference_fn(apply_fn: Callable[[torch.Tensor], torch.Tensor], mesh):
    """fn(global batch) -> the whole output on every rank: the batch cut
    over 'data', ``apply_fn`` (a model in its TP layout, on this rank's
    device) on this rank's slice, the outputs gathered over 'data'."""
    group = mesh.get_group("data")

    @torch.inference_mode()
    def infer(batch):
        out = apply_fn(shard_batch(batch, mesh)).contiguous()
        parts = [torch.empty_like(out) for _ in range(mesh.size(0))]
        dist.all_gather(parts, out, group=group)
        return torch.cat(parts, dim=0)

    return infer


def reduce_gradients(params: Sequence[torch.nn.Parameter],
                     loss: torch.Tensor, mesh) -> torch.Tensor:
    """After ``backward`` on this rank's slice of the batch: average the
    gradients of whole (replicated) parameters, and the loss, over every rank
    of the mesh, and those of a 'model'-sharded parameter over 'data' only
    (each 'model' rank owns other rows). Two all-reduces, each on one flat
    buffer. Returns the mean loss of the global batch (equal slices, so the
    mean of the ranks' means)."""
    params = [p for p in params if p.grad is not None]
    whole = [p.grad for p in params if not getattr(p, "sharded", False)]
    cut = [p.grad for p in params if getattr(p, "sharded", False)]
    flat = torch.cat([g.reshape(-1) for g in whole]
                     + [loss.detach().reshape(1).to(whole[0].dtype)])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    _unflatten(flat, whole)
    if cut:
        group = mesh.get_group("data")
        cflat = torch.cat([g.reshape(-1) for g in cut])
        dist.all_reduce(cflat, group=group)
        cflat /= mesh.size(0)
        _unflatten(cflat, cut)
    return flat[-1].clone()


def _unflatten(flat: torch.Tensor, grads: Sequence[torch.Tensor]) -> None:
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view_as(g))
        i += g.numel()


def make_dp_tp_train_step(model, tx, mesh):
    """Full training step sharded dp x tp: step(imgs, labels, label_lens) ->
    loss on a GLOBAL host batch (the same on every rank). The batch is cut
    over 'data', the wide kernels over 'model' (``shard_params`` first, then
    ``tx`` on the sharded model, so each rank updates its rows with its own
    optimiser state: AdamW is elementwise)."""
    from synapta_tpu_torch.models.train import ctc_objective, make_step

    return make_step(model, tx, ctc_objective, mesh)
