"""One run of one cell: the shelf, set-up, the measured window through
``synapta_tpu_torch.serve.BookQueue``, the trace, the comparison, and the
result line. ``run.py`` is the command; ``run_cell`` is the run itself on a
named device, so that a test can drive it on the CPU.

Everything a cell is made of is found by name: the workload in
``BENCHMARK.json``, its configuration file, its traffic mix
(``traffic/<mix>.json``), the span files (``spans/*.py``) and one reader a
metric (``metrics/<metric>.py``: ``read(run) -> number or None``).

A configuration may also bring the pipeline's vision-LLM client
(``"vision_llm": {"client": "synapta_tpu_torch.<module>:<factory>",
"args": {...}}``, ``make_client``) and comparisons of its own
(``"compare": [<name>, ...]``, files ``compare/<name>.py``,
``check.comparisons``). A configuration without those keys runs as before.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import inspect
import json
import os
import platform
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "synapta_tpu")
CLIENT_PACKAGE = "synapta_tpu_torch."


def load_benchmark(path: str = os.path.join(REPO, "BENCHMARK.json")) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(bench: dict, workload: str, root: str = REPO) -> dict:
    """-> {"workload", "config", "mix", "end_to_end", "per_layer"}: the
    cell's entry, its configuration file, and the metrics it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    w = cells[workload]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(os.path.join(root, cfg["file"])) as f:
        config = json.load(f)

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return {"workload": w, "config": config, "mix": w["traffic"],
            "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


def reader(name: str, root: str = HERE):
    path = os.path.join(root, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def make_client(spec: dict, device: str, seed: int):
    """The configuration's vision-LLM client: ``spec["client"]`` names a
    factory ``synapta_tpu_torch.<module>:<name>`` of the program, called with
    ``spec["args"]`` and, where its signature names them, ``device`` and
    ``seed``. It has the pipeline's client interface, ``stats`` (``calls``,
    ``failures``) and ``shutdown()``."""
    target = spec.get("client")
    mod_name, _, attr = str(target).partition(":")
    if not (mod_name.startswith(CLIENT_PACKAGE) and attr.isidentifier()):
        raise SystemExit(f"portbench: vision_llm client {target!r} is not "
                         f"'{CLIENT_PACKAGE}<module>:<factory>'")
    factory = getattr(importlib.import_module(mod_name), attr)
    kw = dict(spec.get("args", {}))
    params = inspect.signature(factory).parameters
    kw.update((k, v) for k, v in (("device", device), ("seed", seed)) if k in params)
    return factory(**kw)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package (compared whole: ``synapta_tpu_torch`` is not ``synapta_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def process_start_epoch() -> float:
    """When this process started (the kernel's record, which an exec
    keeps), in seconds since the epoch."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    ticks = int(fields[19])  # field 22 of stat(5), counted after the name
    with open("/proc/stat") as f:
        btime = next(int(ln.split()[1]) for ln in f if ln.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def host_line() -> dict:
    """The host's CPU: ``/proc/cpuinfo``'s first model name (or vendor,
    family, model and stepping where it gives none) and the core count."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                k, _, v = ln.partition(":")
                info.setdefault(k.strip(), v.strip())
    except OSError:
        pass
    model = info.get("model name") or " ".join(
        f"{k} {info[k]}" for k in ("vendor_id", "cpu family", "model", "stepping")
        if k in info) or platform.processor() or "unknown"
    return {"host_cpu": model, "cores": os.cpu_count()}


def card_line() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,"
             "clocks.mem", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def assemble(cell: dict, run, trace: bool, numbers: dict, limits: dict,
             dev_info: dict, root: str = HERE) -> dict:
    """The result object: the cell's end-to-end metrics (``trace`` off) or
    per-layer metrics (on) that their readers find, the device, with a
    trace its busy seconds and breakdown, and last ``checks``, every number
    compared beside its limit."""
    from portbench import check

    ok, table = check.verdict(numbers, limits)
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        v = reader(m["name"], root)(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev_info = dict(dev_info)
    result = {"correct": ok, "attempted": len(run.books),
              "failed": sum(b["status"] != "done" or b["errors"] > 0
                            for b in run.books),
              "metrics": metrics, "device": dev_info}
    if trace and run.trace is not None:
        dev_info["busy_s"] = run.busy_s
        dev_info["window_s"] = run.window_s
        result["breakdown"] = {"device_ops": run.trace.op_totals(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = table
    return result


def _say(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", workers: int = None,
             proc_start: float = None, mix: dict = None, root: str = REPO,
             control: bool = False, shelf_books: int = None) -> dict:
    """One run; -> the result object (the last line). ``mix`` overrides the
    traffic file (tests); ``control`` puts the fp8 reference in the
    program's place for the model comparisons (and each configuration
    comparison's control in its place); ``shelf_books`` makes only the
    shelf's first books (short calibration runs)."""
    import torch

    from portbench import check, counts, shelf, tracing

    proc_start = time.time() if proc_start is None else proc_start
    cell = cell_spec(bench, workload, root)
    config = cell["config"]
    own = check.comparisons(config.get("compare", []), os.path.join(root, "portbench"))
    mix = mix if mix is not None else shelf.load_mix(cell["mix"], os.path.join(root, "portbench"))
    scanned = config["generator"] == "scanned_book"
    if shelf_books:
        mix = dict(mix, books=min(int(mix["books"]), shelf_books))
    if "visuals_per_page" in config:
        mix = dict(mix, visuals_per_page=config["visuals_per_page"])
    tmp = tempfile.mkdtemp(prefix="portbench_")
    client = None
    try:
        warm, books, gen_s = shelf.generate(
            mix, cell["mix"], seed, os.path.join(tmp, "shelf"),
            workers or os.cpu_count() or 1)
        _say({"generation_s": gen_s, "books": len(books),
              "pages": sum(b["pages"] for b in books),
              "visuals": sum(len(v) for b in books for v in b["visuals"])})

        # ---------------------------------------------------- set-up
        from synapta_tpu_torch.config import PipelineConfig
        from synapta_tpu_torch.serve import BookQueue
        from synapta_tpu_torch.utils.profiler import TIMERS

        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.init()
            from synapta_tpu_torch.ops import _build

            _build.library()
        if "vision_llm" in config:  # the engine's build counts as set-up
            client = make_client(config["vision_llm"], device, seed)
        out_root = os.path.join(tmp, "out")
        q = BookQueue(output_root=out_root,
                      config=PipelineConfig(**config["pipeline"]),
                      llm_client=client, device=device)
        q.add(warm["path"], book_id="warmup")
        q.run()
        if q.jobs[0].status != "done":
            raise RuntimeError(f"warm-up book failed: {q.jobs[0].error_msg}")

        rec = tracing.Recorder()
        caps = check.Captures(seed)
        undo = tracing.install(rec, os.path.join(root, "portbench"))
        undo += caps.install()
        own_caps = {}
        for name, mod in own.items():
            own_caps[name], u = mod.install(seed, check.SAMPLES)
            undo += u
        rec.tracing = trace
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()

        # ---------------------------------------------------- window
        timers0 = dict(TIMERS.totals)
        llm0 = dict(client.stats) if client is not None else None
        setup_s = time.time() - proc_start - gen_s
        cpu0 = time.process_time()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        done, reused = [], 0
        k = 0
        while k == 0 or time.perf_counter() < deadline:
            b = books[k % len(books)]
            reused += k >= len(books)
            q.jobs = []
            job = q.add(b["path"], book_id=f"b{k:05d}")
            q.run()
            done.append({"book_id": job.book_id, "status": job.status,
                         "errors": job.errors, "pages": b["pages"],
                         "segments": job.segments, "visuals": b["visuals"],
                         "texts": b["texts"]})
            k += 1
        t1 = time.perf_counter()
        window_s = t1 - t0
        llm = ({"llm_calls": client.stats["calls"] - llm0["calls"],
                "llm_failures": client.stats["failures"] - llm0["failures"]}
               if client is not None else {})
        proc_cpu_s = time.process_time() - cpu0
        if prof is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
        rec.tracing = False
        for u in reversed(undo):
            u()
        timers = {k_: v - timers0.get(k_, 0.0) for k_, v in TIMERS.totals.items()}
        spans = rec.between(t0, t1)
        for sp, b in zip([s for s in spans if s.name == "serve"], done):
            b["turnaround_s"] = sp.dur
        mem = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        finished = [b for b in done if b["status"] == "done"]
        errors = sum(b["errors"] for b in done)
        turn = sorted(b.get("turnaround_s", 0.0) for b in done)
        _say({"books_done": len(finished), "books_started": len(done),
              "pages_done": sum(b["pages"] for b in finished),
              "stats_errors": errors, "window_s": window_s,
              "turnaround_s": [turn[len(turn) // 2], turn[int(0.9 * (len(turn) - 1))],
                               turn[-1]],
              "stage_s": dict(sorted(((k_, v) for k_, v in timers.items() if v > 0.01),
                                     key=lambda kv: -kv[1])),
              "proc_cpu_s": proc_cpu_s, **llm})
        if reused:
            _say({"warning": f"the shelf ran out: {reused} books sent a second "
                             "time; a later benchmark PR must grow the shelf"})

        dtrace, t_read = None, time.perf_counter()
        if prof is not None:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            dtrace = tracing.read_chrome_trace(path)
            os.remove(path)
            if not dtrace.ops:  # no device operation was traced
                dtrace = None
        if dtrace is not None:
            tracing.attribute(dtrace, spans)
        t_cmp = time.perf_counter()

        # ---------------------------------------------------- comparison
        caps.to_host()
        own_caps = {n: own[n].to_host(c) for n, c in own_caps.items()}
        if client is not None:  # freed with the program, before any reference
            client.shutdown()
            client = None
        del q
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        numbers = check.compare(caps, dev, control=control)
        numbers.update(check.outputs(finished, out_root, scanned))
        numbers.update(llm)
        for name, mod in own.items():  # TF32 is off since check.compare
            check.merge(numbers, mod.numbers(own_caps[name], dev, control),
                        f"compare/{name}.py")
        _say({"trace_read_s": t_cmp - t_read,
              "compare_s": time.perf_counter() - t_cmp})
        limits = dict(config.get("limits", {}))

        run = SimpleNamespace(
            spans=spans, timers=timers, books=done, window_s=window_s,
            pages=sum(b["pages"] for b in finished),
            segments=sum(b["segments"] for b in finished),
            trace=dtrace, busy_s=dtrace.busy_s() if dtrace else None,
            models=config["models"], counts=counts, setup_s=setup_s)
        dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                    "kind": (torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else platform.processor()),
                    "count": 1, "memory_peak_bytes": mem}
        return assemble(cell, run, trace, numbers, limits, dev_info,
                        os.path.join(root, "portbench"))
    finally:
        if client is not None:
            client.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
