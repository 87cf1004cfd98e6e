"""The port's multi-device code (synapta_tpu_torch/parallel) on the CPU,
against the JAX package on its 8-virtual-device mesh and against the port's
own unsharded results. Ranks are real processes joined by gloo
(tests/torch_distworker.py); a data mesh on the CPU runs its shards in turn.

Sizes are small (dim 128, 1 block, 32 x 128 tiles, batch 8) unless a check
needs the shipped weights. Inputs come from numpy seeds; flax parameters
cross over through ``params_from_flax``. Tolerances:

- mesh sizes, errors, the set of sharded kernels, shard-against-whole
  results of the analyze pass, and the segments of a book on 1 and 4 shards:
  equal.
- the sharded analyze pass against JAX's on its 4-device mesh: the
  tolerances of tests/test_torch_analyze.py (counts and boxes exact, float
  features 1e-5 relative, k-means centres 1e-3; the variance, which that
  file holds to the float64 value because JAX's float32 sum is ~1e-5 off
  it, within 1e-4 of JAX's).
- the sharded forward: logits within 1e-4 of the single-process ones and of
  JAX's (float32; another order of summation in the gathered matmuls).
- two dp x tp steps (float32, adamw b2 0.98, warmup 2 of 10): losses rtol
  1e-5, parameters within 1e-6; a parameter whose gradient is at rounding
  level may take Adam's other sign, so a leaf may differ by up to
  2 x the summed learning rates on at most 1e-4 of its entries (the
  attention key bias, whose gradient is zero in exact arithmetic, on all).
- ``train(use_mesh=True)`` on one gloo rank against ``use_mesh=False``:
  equal losses and checkpoint bytes (an all-reduce over one rank is the
  identity).
"""
import glob
import json
import os
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
import optax

from synapta_tpu.models import recognizer as jrec
from synapta_tpu.models import synthdata as jsd
from synapta_tpu.ops import features as jfeat
from synapta_tpu.parallel import mesh as jmesh
from synapta_tpu_torch.models import msgpack_io
from synapta_tpu_torch.models import recognizer as trec
from synapta_tpu_torch.models import train as ttrain
from synapta_tpu_torch.ops import features as tfeat
from synapta_tpu_torch.parallel import mesh as tmesh
from synapta_tpu_torch.parallel.launch import free_port, run_ranks

import torch_distworker as W
from test_torch_analyze import FLOAT_KEYS
from test_torch_train import leaves, np_tree
from torchfixtures import crops

WIDTH = 128
LR_SUM = sum(float(optax.warmup_cosine_decay_schedule(*W.SCHED)(c))
             for c in range(2))


def need_8_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def fake_mesh(data, model):
    """What ``param_spec`` reads of a rank mesh: its axis sizes."""
    return types.SimpleNamespace(size=lambda dim: (data, model)[dim])


# ------------------------------------------------------------------ meshes


@pytest.mark.parametrize("n", range(1, 9))
def test_data_mesh_auto_sizes_match_jax(n):
    need_8_devices()
    want = jmesh.data_mesh_auto(16, n)
    got = tmesh.data_mesh_auto(16, n, "cpu")
    assert got.shape == dict(want.shape)
    assert got.size == len(got.devices) == len(got.streams)
    assert all(d.type == "cpu" for d in got.devices)


def test_data_mesh_cuda_is_never_virtual_unasked(monkeypatch):
    """One GPU: more shards raise unless virtual; the pipeline's own mesh
    (data_mesh_auto) has size 1 and no stream of its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        tmesh.data_mesh(2, "cuda")
    with pytest.raises(ValueError, match="requested 4 devices, have 1"):
        tmesh.data_mesh_auto(16, 4, "cuda")
    one = tmesh.data_mesh_auto(16, None, "cuda")
    assert one.shape == {"data": 1} and one.streams == (None,)
    assert one.devices == (torch.device("cuda", 0),)


def test_data_mesh_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tmesh.data_mesh(1, "cuda")


@pytest.mark.parametrize("n,model_axis,msg", [
    (9, 1, "requested 9 devices, have"),
    (8, 3, "8 devices not divisible by model axis 3"),
])
def test_make_mesh_errors_match_jax(monkeypatch, n, model_axis, msg):
    need_8_devices()
    with pytest.raises(ValueError, match=msg):
        jmesh.make_mesh(n, model_axis)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 8)
    with pytest.raises(ValueError, match=msg):
        tmesh.make_mesh(n, model_axis, "cpu")


def test_make_mesh_needs_the_whole_group(monkeypatch):
    with pytest.raises(RuntimeError, match="init_distributed"):
        tmesh.make_mesh(1, 1, "cpu")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 8)
    with pytest.raises(ValueError, match="whole process group"):
        tmesh.make_mesh(4, 2, "cpu")


def flax_init(dim, blocks, width):
    jm = jrec.Recognizer(dim=dim, blocks=blocks, dtype=jnp.float32)
    return jm, np_tree(jm.init(jax.random.PRNGKey(0),
                               jnp.zeros((2, 32, width, 1)))["params"])


@pytest.mark.parametrize("dim,blocks,width", [(128, 1, WIDTH), (192, 2, 384)])
def test_sharded_parameter_set_matches_jax(dim, blocks, width):
    """The kernels cut over a model axis of 2 are the ones JAX's param_spec
    names: every conv and Dense kernel but the odd-width head."""
    need_8_devices()
    _, tree = flax_init(dim, blocks, width)
    mesh = jmesh.make_mesh(8, model_axis=2)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    want = sorted(
        tuple(k.key for k in path) for path, v in flat
        if "model" in str(jmesh.param_spec(tuple(k.key for k in path), v,
                                           mesh).spec))
    model = W.build(tree, width)
    got = sorted(tmesh.sharded_kernels(model, fake_mesh(4, 2)))
    assert got == want and len(got) == 5 + 6 * blocks
    assert ("Dense_0", "kernel") not in got  # 161 classes
    assert set(got) <= set(trec.kernel_modules(model))
    assert tmesh.sharded_kernels(model, fake_mesh(8, 1)) == []


# --------------------------------------------------------- the analyze pass


@pytest.fixture(scope="module")
def chunk8():
    c, sizes = crops(8, blank_last=True)
    return np.ascontiguousarray(c[:, ::2, ::2]), sizes // 2


def test_device_analyze_sharded_equals_unsharded(chunk8):
    """Every op of the pass is per crop: 4 shards of 2 crops give the bits
    of one pass over 8."""
    c, sizes = chunk8
    mesh = tmesh.data_mesh(4, "cpu")
    whole = tfeat.device_analyze_dispatch(c, sizes=sizes, device="cpu")
    parts = tfeat.device_analyze_dispatch(c, sizes=sizes, mesh=mesh)
    assert isinstance(parts, tmesh.Sharded) and len(parts.parts) == 4
    assert torch.equal(parts.cpu(), whole)
    one = tfeat.device_analyze_dispatch(c, sizes=sizes,
                                        mesh=tmesh.data_mesh(1, "cpu"))
    assert torch.equal(one, whole)
    with pytest.raises(ValueError, match="does not split"):
        tfeat.device_analyze_dispatch(c[:6], sizes=sizes[:6], mesh=mesh)


def test_device_analyze_sharded_matches_jax(chunk8):
    """Both on their default routes (XLA opens, the union count)."""
    need_8_devices()
    c, sizes = chunk8
    jf, jb = jfeat.device_analyze(c, sizes=sizes, mesh=jmesh.data_mesh(4))
    tf, tb = tfeat.device_analyze(c, sizes=sizes, device="cpu",
                                  mesh=tmesh.data_mesh(4, "cpu"))
    assert set(tf) == set(jf)
    assert np.array_equal(tb, np.asarray(jb))
    for k in jfeat._SCALAR_KEYS:
        if k == "variance":  # JAX's own float32 sum is ~1e-5 off the exact one
            np.testing.assert_allclose(tf[k], jf[k], rtol=1e-4)
        elif k in FLOAT_KEYS:
            np.testing.assert_allclose(tf[k], jf[k], rtol=1e-5, err_msg=k)
        else:
            assert np.array_equal(tf[k], jf[k]), k
    np.testing.assert_allclose(tf["kmeans_centers"], jf["kmeans_centers"],
                               rtol=1e-3, atol=1e-3)
    assert np.array_equal(tf["kmeans_counts"], jf["kmeans_counts"])
    assert (tb[..., 4] > 0).sum() > 5  # some real text lines


# ------------------------------------------------- the dp x tp training step


def batches():
    return [jsd.make_batch(np.random.default_rng(20 + s), batch=8, width=WIDTH,
                           max_label=16) for s in range(2)]


@pytest.fixture(scope="module")
def single():
    """The port's single-process run: logits and two make_train_step steps."""
    _, tree = flax_init(128, 1, WIDTH)
    model = W.build(tree, WIDTH)
    bs = batches()
    with torch.no_grad():
        logits = model(torch.from_numpy(bs[0][0]).permute(0, 3, 1, 2)).numpy()
    step = ttrain.make_train_step(model, W.adamw(model))
    losses = [float(step(*b)) for b in bs]
    return {"tree": tree, "batches": bs, "logits": logits, "losses": losses,
            "params": trec.params_to_flax(model.state_dict())}


def assert_params_close(got, want):
    want = dict(leaves(want))
    for path, g in leaves(got):
        d = np.abs(g - want[path])
        assert d.max() <= 2 * LR_SUM + 1e-6, path
        if not path.endswith("key/bias"):
            assert (d > 1e-6).mean() <= 1e-4, (path, (d > 1e-6).mean(), d.max())


def assert_run_close(run, ref):
    np.testing.assert_allclose(run["logits"], ref["logits"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(run["losses"], ref["losses"], rtol=1e-5)
    assert_params_close(run["params"], ref["params"])


@pytest.fixture(scope="module")
def four_ranks(single):
    return run_ranks(W.steps_workload, 4, 2, single["tree"], single["batches"],
                     timeout=300)


def test_dp_tp_four_ranks_agree_with_each_other(four_ranks):
    assert [r["rank"] for r in four_ranks] == [0, 1, 2, 3]
    for r in four_ranks:
        assert r["mesh"] == {"data": 2, "model": 2}
        assert r["losses"] == four_ranks[0]["losses"]
        assert np.array_equal(r["logits"], four_ranks[0]["logits"])
        for (p, a), (_, b) in zip(leaves(r["params"]),
                                  leaves(four_ranks[0]["params"])):
            assert np.array_equal(a, b), p
    # the kernels a rank holds a part of are the ones param_spec names
    model = W.build(four_ranks[0]["params"], WIDTH)
    modules = trec.kernel_modules(model)
    names = {id(m): n for n, m in model.named_modules()}
    want = sorted(names[id(modules[p])] + ".weight"
                  for p in tmesh.sharded_kernels(model, fake_mesh(2, 2)))
    assert four_ranks[0]["cut"] == want and len(want) == 11


def test_dp_tp_four_ranks_match_single_process(four_ranks, single):
    assert_run_close(four_ranks[0], single)
    assert np.isfinite(single["losses"]).all()
    moved = max(np.abs(a - b).max() for (_, a), (_, b) in zip(
        leaves(single["params"]), leaves(single["tree"])))
    assert moved > 1e-4  # the second step has a learning rate


def test_dp_tp_four_ranks_match_jax(four_ranks, single):
    """JAX's make_dp_tp_train_step on a dp 2 x tp 2 mesh of the virtual CPU
    devices, from the same weights and batches, and its sharded forward."""
    need_8_devices()
    jm, _ = flax_init(128, 1, WIDTH)
    mesh = jmesh.make_mesh(4, model_axis=2)
    params = jmesh.shard_params(jax.tree.map(jnp.asarray, single["tree"]), mesh)
    imgs = single["batches"][0][0]
    logits = np.asarray(jmesh.make_inference_fn(
        lambda p, x: jm.apply({"params": p}, x), mesh, params)(params, imgs))
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(*W.SCHED), 0.9, 0.98)
    state = jax.device_put(tx.init(params), jmesh.replicated(mesh))
    step = jmesh.make_dp_tp_train_step(jm, tx, mesh, params)
    losses = []
    for b in single["batches"]:
        params, state, loss = step(params, state,
                                   *jmesh.shard_batch(tuple(b), mesh))
        losses.append(float(loss))
    assert_run_close(four_ranks[0], {"logits": logits, "losses": losses,
                                     "params": np_tree(params)})


@pytest.mark.parametrize("world,model_axis", [(1, 1), (2, 1), (2, 2)])
def test_ranks_agree_with_single_process(single, world, model_axis):
    """One rank, dp 2 and tp 2 (two real processes, gloo) against the
    single-process run of the same workload."""
    runs = run_ranks(W.steps_workload, world, model_axis, single["tree"],
                     single["batches"], timeout=300)
    assert runs[0]["mesh"] == {"data": world // model_axis, "model": model_axis}
    assert len(runs[0]["cut"]) == (11 if model_axis == 2 else 0)
    for r in runs:
        assert r["losses"] == runs[0]["losses"]
        assert_run_close(r, single)


def test_run_ranks_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed:") as e:
        run_ranks(W.failing_rank, 2, timeout=120)
    assert "ValueError: rank 1 gives up" in str(e.value)


# ------------------------------------------------------- init_distributed


def test_init_distributed_single_process_noop(monkeypatch):
    for k in ("SYNAPTA_COORDINATOR", "SYNAPTA_NUM_PROCESSES",
              "SYNAPTA_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: pytest.fail("must not be called"))
    assert tmesh.init_distributed(device="cpu") is False
    assert tmesh.init_distributed(num_processes=1, device="cpu") is False
    assert not dist.is_initialized()


@pytest.mark.parametrize("backend,want", [(None, "gloo"), ("nccl", "nccl")])
def test_init_distributed_arg_plumbing(monkeypatch, backend, want):
    """Env vars and arguments reach init_process_group; the call itself is
    stubbed. The backend is gloo for the CPU unless named."""
    calls = {}

    def fake_init(backend, init_method=None, world_size=None, rank=None):
        calls.update(backend=backend, init_method=init_method,
                     world_size=world_size, rank=rank)

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    monkeypatch.setenv("SYNAPTA_COORDINATOR", "10.0.0.1:8476")
    monkeypatch.setenv("SYNAPTA_NUM_PROCESSES", "4")
    monkeypatch.setenv("SYNAPTA_PROCESS_ID", "2")
    assert tmesh.init_distributed(backend=backend, device="cpu") is True
    assert calls == {"backend": want, "init_method": "tcp://10.0.0.1:8476",
                     "world_size": 4, "rank": 2}
    assert tmesh.init_distributed("h:1", 2, 1, device="cpu") is True
    assert calls == {"backend": "gloo", "init_method": "tcp://h:1",
                     "world_size": 2, "rank": 1}


# ------------------------------------------------------------ the trainer


def test_train_use_mesh_one_rank_equals_no_mesh(tmp_path, monkeypatch):
    """``train(use_mesh=True)`` joins a real gloo group of one rank from the
    env vars, builds the mesh over it and leaves no group behind."""
    def run(use_mesh, name):
        out = str(tmp_path / name)
        r = ttrain.train(steps=101, batch=2, seed=0, out=out, log_every=50,
                         init_from=msgpack_io.WEIGHTS_PATH, device="cpu",
                         use_mesh=use_mesh)
        return r, open(out, "rb").read()

    for k in ("SYNAPTA_COORDINATOR", "SYNAPTA_NUM_PROCESSES",
              "SYNAPTA_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    plain, plain_bytes = run(False, "plain.msgpack")
    lone, lone_bytes = run(True, "lone.msgpack")  # no coordinator: no group
    monkeypatch.setenv("SYNAPTA_COORDINATOR", f"127.0.0.1:{free_port()}")
    monkeypatch.setenv("SYNAPTA_NUM_PROCESSES", "1")
    monkeypatch.setenv("SYNAPTA_PROCESS_ID", "0")
    seen = []
    make_mesh = tmesh.make_mesh
    monkeypatch.setattr(tmesh, "make_mesh", lambda **kw: seen.append(
        make_mesh(**kw)) or seen[-1])
    meshed, meshed_bytes = run(True, "meshed.msgpack")
    assert not dist.is_initialized()
    assert [tmesh.mesh_shape(m) for m in seen] == [{"data": 1, "model": 1}]
    assert meshed["losses"] == plain["losses"] == lone["losses"]
    assert meshed["cer"] == plain["cer"] < 0.05
    assert meshed_bytes == plain_bytes == lone_bytes


# ------------------------------------------------ the pipeline on a data mesh


def test_pipeline_dp_mesh_identical_outputs(tmp_path):
    """The SAME book through the port's pipeline on 1 and on 4 data shards
    (cfg.data_devices; the CPU's mesh is virtual) writes identical
    visual_segments.json."""
    from synapta_tpu_torch.config import PipelineConfig
    from synapta_tpu_torch.io.pdf_writer import make_test_book
    from synapta_tpu_torch.pipeline import VisualSegmentationPipeline

    pdf = str(tmp_path / "book.pdf")
    make_test_book(pdf, pages=4, seed=3)

    def run(n_dev, out):
        pipe = VisualSegmentationPipeline(
            book_id="dpbook", pdf_path=pdf, output_dir=str(tmp_path / out),
            use_mermaid=False,
            config=PipelineConfig(use_vision_llm=False, data_devices=n_dev),
            resume=False, device="cpu",
        )
        pipe.process()
        pipe.close()
        assert pipe.stats.errors == 0
        assert pipe.mesh.shape == {"data": n_dev}
        assert (pipe.ocr.mesh is pipe.mesh) == (n_dev > 1)
        payload = json.load(open(tmp_path / out / "dpbook_visual_segments.json"))
        for s in payload["segments"]:
            s["image_path"] = os.path.basename(s["image_path"])
        return payload

    a = run(1, "out1")
    b = run(4, "out4")
    assert a["total_segments"] == b["total_segments"] > 0
    assert a["segments"] == b["segments"]
    assert any(s["ocr_result"]["blocks"] for s in a["segments"])


def test_ocr_missing_weights_names_the_ports_trainer(tmp_path):
    from synapta_tpu_torch.ocr.processor import TorchOCR

    with pytest.raises(FileNotFoundError,
                       match="python -m synapta_tpu_torch.models.train"):
        TorchOCR(weights_path=str(tmp_path / "none.msgpack"), device="cpu")


# ------------------------------------------------- dry run, entry, profiler


def test_dryrun_multichip_two_shards(capfd):
    from synapta_tpu_torch import graft_entry

    graft_entry.dryrun_multichip(2, "cpu")
    out = capfd.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("dryrun_multichip OK")]
    assert len(line) == 1, out
    assert "pipeline mesh={'data': 2} train mesh={'data': 2, 'model': 1}" in line[0]
    assert "crops=8 loss=" in line[0] and "(1dev==2dev) digest=" in line[0]


def test_dryrun_failure_raises(monkeypatch):
    from synapta_tpu_torch import graft_entry

    with pytest.raises(RuntimeError, match="dryrun subprocess failed"):
        graft_entry.dryrun_multichip(2, "meta")


def test_entry_forward():
    from synapta_tpu_torch import graft_entry
    from synapta_tpu_torch.models import charset

    fn, (model, imgs) = graft_entry.entry("cpu")
    out = fn(model, imgs)
    assert tuple(imgs.shape) == (8, 1, 32, 384)
    assert tuple(out.shape) == (8, 96, charset.NUM_CLASSES)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    assert not out.requires_grad
    with pytest.raises(RuntimeError):
        graft_entry.entry("cuda")


def test_torch_trace_writes_a_trace(tmp_path, monkeypatch):
    from synapta_tpu_torch.utils.profiler import torch_trace

    monkeypatch.setenv("SYNAPTA_TRACE_DIR", str(tmp_path / "env"))
    for log_dir, where in ((str(tmp_path / "arg"), "arg"), (None, "env")):
        with torch_trace(log_dir) as prof:
            torch.ones(64, 64) @ torch.ones(64, 64)
        files = glob.glob(str(tmp_path / where / "*.pt.trace.json"))
        assert len(files) == 1
        events = json.load(open(files[0]))["traceEvents"]
        assert any("mm" in e.get("name", "") for e in events)
        assert any("mm" in e.key for e in prof.key_averages())
