"""The hand-written CUDA kernels against their plain PyTorch twins, on the GPU.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode) and
skips without one. The file imports neither jax nor the JAX package, so it
also runs on a GPU machine without JAX, bypassing the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Inputs are seeded numpy arrays and crops drawn with Pillow; results must
be bit-identical, and the CC kernel's rounds must equal the twin's. The two
trainers' steps (no kernel of their own: cuDNN, cuBLAS and torch's CTC) are
held to their CPU runs within the tolerances each test states. The data
mesh's shards (further streams of the one GPU) must give the bits of the
unsharded pass, and two ranks that share the GPU (gloo) the single-process
training steps within the bounds of tests/test_torch_parallel.py.
"""
import numpy as np
import pytest
import torch


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


def _masks():
    rng = np.random.default_rng(0)
    blobs = np.zeros((3, 64, 128), np.float32)
    for b in range(3):
        for _ in range(12):
            y, x = rng.integers(0, 56), rng.integers(0, 118)
            h, w = rng.integers(2, 9), rng.integers(2, 11)
            blobs[b, y:y + h, x:x + w] = 1.0
    return [
        blobs,
        (rng.random((16, 256, 256)) < 0.45).astype(np.float32),
        _drawn(16, 256) / 255.0 < 0.5,  # ink of drawn crops, the main-path shape
        (rng.random((1, 512, 512)) < 0.5).astype(np.float32),  # detector's size
        (rng.random((2, 37, 53)) < 0.6).astype(np.float32),  # ragged shape
        np.zeros((1, 16, 16), np.float32),
        np.ones((1, 16, 16), np.float32),
    ]


def _drawn(n, size):
    """n white crops with text, rules, boxes and a bar chart drawn in black
    by Pillow (seeded): the kind of page regions the pipeline renders."""
    from PIL import Image, ImageDraw

    rng = np.random.default_rng(7)
    out = np.empty((n, size, size), np.float32)
    for i in range(n):
        im = Image.new("L", (size, size), 255)
        d = ImageDraw.Draw(im)
        for _ in range(6):
            x, y = (int(v) for v in rng.integers(0, size - 60, 2))
            d.text((x, y), "Figure 3.%d  y = x^2" % i, fill=0)
        for _ in range(3):
            y = int(rng.integers(0, size))
            d.line((0, y, size - 1, y), fill=0, width=int(rng.integers(1, 3)))
            x = int(rng.integers(0, size - 40))
            d.rectangle((x, y // 2, x + 30, y // 2 + 20), outline=0)
        for j in range(5):
            h = int(rng.integers(10, size // 3))
            d.rectangle((20 + 14 * j, size - h, 30 + 14 * j, size - 1), fill=96)
        out[i] = np.asarray(im, np.float32)
    return out


def _grays():
    rng = np.random.default_rng(1)
    blocks = rng.integers(0, 2, (4, 64, 64)).repeat(8, 1).repeat(8, 2) * 255.0
    blank = np.full((1, 512, 512), 255.0, np.float32)
    return [
        np.concatenate([_drawn(15, 512), blank]),  # the main-path shape
        blocks.astype(np.float32),
        rng.integers(0, 256, (2, 512, 512)).astype(np.float32),
        rng.integers(0, 256, (2, 40, 70)).astype(np.float32),  # ragged shape
        np.full((1, 64, 64), 255.0, np.float32),
        # one crop, W no multiple of 32, H shorter than either window's half
        (rng.integers(0, 2, (1, 7, 3)).repeat(15, 2) * 255.0).astype(np.float32),
        # narrower than a window's half, taller than a stencil band
        (rng.integers(0, 2, (1, 5, 13)).repeat(9, 1) * 255.0).astype(np.float32),
        rng.integers(0, 256, (1, 17, 33)).astype(np.float32),  # row H-1 is a halo
        rng.integers(0, 256, (3, 1, 100)).astype(np.float32),  # one row
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("conn,cap", [(8, 6), (8, 4), (4, 6), (8, 10), (8, 64),
                                      (4, 0)])
def test_cc_kernel_equals_twin(conn, cap):
    _need_cuda()
    from synapta_tpu_torch.ops.cc import connected_components_reference
    from synapta_tpu_torch.ops.cuda_cc import connected_components_cuda

    for m in _masks():
        x = torch.from_numpy(np.ascontiguousarray(m, np.float32)).cuda()
        got, rounds = connected_components_cuda(x, cap, conn, return_rounds=True)
        torch.cuda.synchronize()
        want, want_rounds = connected_components_reference(x, cap, conn,
                                                           return_rounds=True)
        assert torch.equal(got, want), x.shape
        assert rounds.cpu().tolist() == want_rounds.tolist(), x.shape


@pytest.mark.cuda
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("line_k,grid_k,high", [(20, 25, 150.0), (4, 6, 90.0),
                                                (1, 2, 150.0)])
def test_edge_stats_kernel_equals_twin(line_k, grid_k, high, use_pallas):
    """Both routes, all six (five) counts, on integer-valued gray (the
    default route's sectors are exact for that only)."""
    _need_cuda()
    from synapta_tpu_torch.ops.cuda_kernels import (
        fused_edge_stats_cuda,
        fused_edge_stats_reference,
    )

    for g in _grays():
        x = torch.from_numpy(g).cuda()
        got = fused_edge_stats_cuda(x, line_k, grid_k, high, use_pallas)
        torch.cuda.synchronize()
        want = fused_edge_stats_reference(x, line_k, grid_k, high, use_pallas)
        assert got.shape == (g.shape[0], 5 if use_pallas else 6)
        assert torch.equal(got, want), (g.shape, got.tolist(), want.tolist())
        if not use_pallas:  # the union is no more than the sum, no less than each
            assert bool((got[:, 5] <= got[:, 1] + got[:, 2]).all())
            assert bool((got[:, 5] >= torch.maximum(got[:, 1], got[:, 2])).all())


@pytest.mark.cuda
def test_wrappers_count_launches_and_check_inputs():
    _need_cuda()
    from synapta_tpu_torch.ops.cc import connected_components
    from synapta_tpu_torch.ops.cuda_cc import connected_components_cuda
    from synapta_tpu_torch.ops.cuda_kernels import (
        fused_edge_stats,
        fused_edge_stats_cuda,
    )

    m = torch.ones((1, 8, 8), device="cuda")
    n_cc, n_es = connected_components_cuda.launches, fused_edge_stats_cuda.launches
    connected_components(m)
    fused_edge_stats(m)
    assert connected_components_cuda.launches == n_cc + 1
    assert fused_edge_stats_cuda.launches == n_es + 1
    with pytest.raises(ValueError):
        connected_components(m.to(torch.float64))  # no silent fallback
    with pytest.raises(ValueError):
        fused_edge_stats(m[:, :, ::2])  # not contiguous
    for use_pallas in (False, True):  # either route launches or raises
        n_es = fused_edge_stats_cuda.launches
        fused_edge_stats(m, use_pallas=use_pallas)
        assert fused_edge_stats_cuda.launches == n_es + 1
        with pytest.raises(ValueError):
            fused_edge_stats(m.to(torch.float64), use_pallas=use_pallas)
        with pytest.raises(ValueError):
            fused_edge_stats(m[0], use_pallas=use_pallas)  # not (B, H, W)
        with pytest.raises(ValueError):
            fused_edge_stats(m, line_k=0, use_pallas=use_pallas)
        with pytest.raises(ValueError):
            fused_edge_stats_cuda(m.cpu(), use_pallas=use_pallas)
        with pytest.raises(RuntimeError):  # the opens' bitmap outgrows a block
            fused_edge_stats(torch.ones((1, 2048, 2048), device="cuda"),
                             use_pallas=use_pallas)
    with pytest.raises(ValueError):
        connected_components(torch.ones((1, 2048, 2048), device="cuda"))  # too big


@pytest.mark.cuda
def test_db_site_cc_equals_twin():
    """The CC kernel's fifth call site: the DB detector's closed probability
    mask of 16 drawn 512² views, (16, 256, 256), cap 10, 8-connected. Labels
    and rounds equal the twin's; the boxes from the GPU equal the boxes the
    CPU computes from the same mask; the call launches the kernel."""
    _need_cuda()
    from synapta_tpu_torch.models import detector as D
    from synapta_tpu_torch.ops.cc import connected_components_reference
    from synapta_tpu_torch.ops.cuda_cc import connected_components_cuda

    model = D.detector_from_flax(D.load_det_params(), dtype=torch.bfloat16,
                                 device="cuda")
    gray = _drawn(16, 512).astype(np.uint8)
    mask = D.closed_mask(D.db_logits(model, gray), 0.3)
    assert mask.is_cuda and tuple(mask.shape) == (16, 256, 256)
    assert float(mask.sum()) > 0
    got, rounds = connected_components_cuda(mask, 10, 8, return_rounds=True)
    torch.cuda.synchronize()
    want, want_rounds = connected_components_reference(mask, 10, 8,
                                                       return_rounds=True)
    assert torch.equal(got, want)
    assert rounds.cpu().tolist() == want_rounds.tolist()
    n = connected_components_cuda.launches
    boxes = D.mask_boxes(mask)
    assert connected_components_cuda.launches == n + 1
    assert torch.equal(boxes.cpu(), D.mask_boxes(mask.cpu()))


def _step_cuda_vs_cpu(make_model, make_step, batch):
    """One optimiser step of the same float32 model on the GPU and on the
    CPU, constant lr 1e-3 (the trainers' schedules start at 0): the losses,
    the gradients and the updated parameters side by side."""
    from synapta_tpu_torch.models import optim

    runs = []
    for dev in ("cuda", "cpu"):
        torch.manual_seed(0)
        model = make_model().to(dev)
        step = make_step(model, optim.adamw(model.parameters(), 1e-3))
        loss = float(step(*batch))
        runs.append((loss, {k: (p.detach().cpu(), p.grad.cpu())
                            for k, p in model.named_parameters()}))
    (l_gpu, p_gpu), (l_cpu, p_cpu) = runs
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu), (l_gpu, l_cpu)
    close = total = 0
    for k, (w_cpu, g_cpu) in p_cpu.items():
        w_gpu, g_gpu = p_gpu[k]
        scale = float(g_cpu.abs().max())
        assert float((g_gpu - g_cpu).abs().max()) <= 1e-3 * scale + 1e-7, k
        # Adam's first step is lr × sign(g) where |g| >> eps: a gradient at
        # rounding level may take the other sign, 2 lr apart
        d = (w_gpu - w_cpu).abs()
        assert float(d.max()) <= 2e-3 + 1e-6, k
        close += int((d <= 1e-6).sum())
        total += d.numel()
    assert close >= 0.999 * total, (close, total)


@pytest.mark.cuda
def test_recognizer_train_step_cuda_equals_cpu():
    """The full-width recognizer (dim 192, 2 blocks, 32 × 384 tiles), a
    batch of 8 synthetic lines, float32 on both devices (TF32 off)."""
    _need_cuda()
    from synapta_tpu_torch.device import resolve_device
    from synapta_tpu_torch.hostlibs import ensure_synthdata_fonts
    from synapta_tpu_torch.models import train as T
    from synapta_tpu_torch.models.recognizer import params_from_flax
    from synapta_tpu_torch.models.synthdata import make_batch

    resolve_device("cuda")
    ensure_synthdata_fonts()
    tree = T.init_params(torch.Generator().manual_seed(0))

    def make_model():
        m = T.create_model(torch.float32)
        m.load_state_dict(params_from_flax(tree))
        return m

    _step_cuda_vs_cpu(make_model, T.make_train_step,
                      make_batch(np.random.default_rng(0), batch=8))


@pytest.mark.cuda
def test_detector_train_step_cuda_equals_cpu():
    """The detector at 512², float32, on 2 drawn pages with targets from
    their ink (half resolution: the ink as the shrunk-text map and the
    band, threshold 0.3 there)."""
    _need_cuda()
    from synapta_tpu_torch.device import resolve_device
    from synapta_tpu_torch.models import detector as D

    resolve_device("cuda")
    imgs = (_drawn(2, 512) / 255.0).astype(np.float32)[..., None]
    prob_t = (imgs[:, ::2, ::2, 0] < 0.5).astype(np.float32)
    sd = D.init_params(D.Detector(dtype=torch.float32),
                       torch.Generator().manual_seed(0)).state_dict()

    def make_model():
        m = D.Detector(dtype=torch.float32)
        m.load_state_dict(sd)
        return m

    _step_cuda_vs_cpu(make_model, D.make_det_train_step,
                      (imgs, prob_t, prob_t, 0.3 * prob_t))


@pytest.mark.cuda
def test_data_mesh_on_the_gpus_there_are():
    """More shards than GPUs only when asked for by name (virtual): then
    every shard has a stream of its own."""
    _need_cuda()
    from synapta_tpu_torch.parallel.mesh import data_mesh, data_mesh_auto

    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"requested {n + 1} devices, have {n}"):
        data_mesh(n + 1, "cuda")
    mesh = data_mesh(2 * n, "cuda", virtual=True)
    assert mesh.shape == {"data": 2 * n}
    assert len({s.cuda_stream for s in mesh.streams}) == 2 * n
    assert [d.index for d in mesh.devices] == [i % n for i in range(2 * n)]
    auto = data_mesh_auto(16, None, "cuda")
    assert auto.size == max(d for d in range(1, n + 1) if 16 % d == 0)
    if auto.size == 1:
        assert auto.streams == (None,)


@pytest.mark.cuda
def test_kernels_on_shard_streams_equal_twins():
    """Both kernels at the shard shapes of a 2-shard mesh, (8, 256, 256) and
    (8, 512, 512), each shard enqueued on its own stream before any wait."""
    _need_cuda()
    from synapta_tpu_torch.ops.cc import connected_components_reference
    from synapta_tpu_torch.ops.cuda_cc import connected_components_cuda
    from synapta_tpu_torch.ops.cuda_kernels import (
        fused_edge_stats_cuda,
        fused_edge_stats_reference,
    )
    from synapta_tpu_torch.parallel.mesh import data_mesh

    mesh = data_mesh(2, "cuda", virtual=True)
    masks = torch.from_numpy(np.ascontiguousarray(
        _drawn(16, 256) / 255.0 < 0.5, np.float32)).cuda()
    grays = torch.from_numpy(_grays()[0]).cuda()
    torch.cuda.synchronize()
    cc, es = [], []
    for i in range(2):
        with mesh.stream(i):
            cc.append(connected_components_cuda(
                masks[8 * i:8 * i + 8].contiguous(), 6, 8, return_rounds=True))
            es.append([fused_edge_stats_cuda(grays[8 * i:8 * i + 8].contiguous(),
                                             use_pallas=up) for up in (False, True)])
    torch.cuda.synchronize()
    for i in range(2):
        want, rounds = connected_components_reference(
            masks[8 * i:8 * i + 8], 6, 8, return_rounds=True)
        assert torch.equal(cc[i][0], want)
        assert cc[i][1].cpu().tolist() == rounds.tolist()
        for got, up in zip(es[i], (False, True)):
            assert torch.equal(got, fused_edge_stats_reference(
                grays[8 * i:8 * i + 8], use_pallas=up))


@pytest.mark.cuda
def test_device_analyze_two_shards_equals_unsharded():
    """A 16-crop chunk of drawn 512² canvases through the analyze pass on a
    2-shard mesh of the GPU: the packed tensor of the unsharded pass, bit
    for bit, and twice its kernel launches."""
    _need_cuda()
    from synapta_tpu_torch.ops import features as F
    from synapta_tpu_torch.ops.cuda_cc import connected_components_cuda
    from synapta_tpu_torch.ops.cuda_kernels import fused_edge_stats_cuda
    from synapta_tpu_torch.parallel.mesh import Sharded, data_mesh

    canvases = np.repeat(_drawn(16, 512).astype(np.uint8)[..., None], 3, axis=-1)
    sizes = np.full((16, 2), 512, np.int32)
    whole = F.device_analyze_dispatch(canvases, sizes=sizes, device="cuda").cpu()
    n_cc, n_es = connected_components_cuda.launches, fused_edge_stats_cuda.launches
    parts = F.device_analyze_dispatch(canvases, sizes=sizes,
                                      mesh=data_mesh(2, "cuda", virtual=True))
    assert isinstance(parts, Sharded)
    assert [tuple(p.shape) for p in parts.parts] == [(8, whole.shape[1])] * 2
    assert torch.equal(parts.cpu(), whole)
    assert connected_components_cuda.launches == n_cc + 8
    assert fused_edge_stats_cuda.launches == n_es + 2


@pytest.mark.cuda
def test_two_ranks_on_one_gpu_match_single_process():
    """tp 2 on two spawned ranks that share the GPU (gloo; NCCL takes one
    rank a GPU): forward and two float32 dp x tp steps of a small recognizer
    against this process's own steps on the GPU."""
    _need_cuda()
    import torch_distworker as W
    from synapta_tpu_torch.device import resolve_device
    from synapta_tpu_torch.hostlibs import ensure_synthdata_fonts
    from synapta_tpu_torch.models import recognizer as R
    from synapta_tpu_torch.models import train as T
    from synapta_tpu_torch.models.synthdata import make_batch
    from synapta_tpu_torch.parallel.launch import run_ranks

    resolve_device("cuda")
    ensure_synthdata_fonts()
    width = 128
    tree = R.params_to_flax(R.init_params(
        R.Recognizer(dim=128, blocks=1, seq_len=width // 4, dtype=torch.float32),
        torch.Generator().manual_seed(0)).state_dict())
    batches = [make_batch(np.random.default_rng(20 + s), batch=8, width=width,
                          max_label=16) for s in range(2)]
    model = W.build(tree, width).cuda()
    step = T.make_train_step(model, W.adamw(model))
    losses = [float(step(*b)) for b in batches]
    want = R.params_to_flax(model.state_dict())
    runs = run_ranks(W.steps_workload, 2, 2, tree, batches, "gloo", "cuda",
                     timeout=300)
    lr_sum = 5e-4  # the schedule's first two values: 0 and 1e-3 / 2
    for r in runs:
        assert r["mesh"] == {"data": 1, "model": 2} and len(r["cut"]) == 11
        assert r["losses"] == runs[0]["losses"]
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)

        def walk(got, ref, path=""):
            for k, v in got.items():
                if isinstance(v, dict):
                    walk(v, ref[k], path + k + "/")
                    continue
                # Adam's first moving step is lr x sign(g): a gradient at
                # rounding level may take the other sign, 2 lr apart
                d = np.abs(v - ref[k])
                assert d.max() <= 2 * lr_sum + 1e-6, path + k
                if not (path + k).endswith("key/bias"):
                    assert (d > 1e-6).mean() <= 1e-3, path + k

        walk(r["params"], want)
