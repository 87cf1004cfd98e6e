"""The vision-LLM configuration's own files: the traffic plan of
``digital_chapters_llm`` (every seed the same work), the reference copy,
the counts against a hand count, and one run of the cell on the CPU with
the model cut to a tiny size (the program in float32 against its
reference; the fp8 control read false)."""
import json
import os
import shutil

import numpy as np
import pytest

from portbench import harness, mistral4_counts as M, shelf

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PB)
CELL = "digital-chapters-mistral4"
TINY = dict(vocab_size=2048, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8,
            v_head_dim=16, moe_intermediate_size=32, n_routed_experts=8,
            vision=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                        intermediate_size=64))


def mix(seed_books=12):
    m = shelf.load_mix("digital_chapters_llm")
    cfg = json.load(open(os.path.join(PB, "configs/textbook_digital_mistral4.json")))
    return dict(m, visuals_per_page=cfg["visuals_per_page"], books=seed_books)


def kinds(spec, batch=32):
    """Per super-batch, the cycle kinds of its pages (text-only pages 0)."""
    out, n = [], 0
    for b0 in range(0, spec.pages, batch):
        ks = []
        for p in range(b0, min(spec.pages, b0 + batch)):
            if p in spec.text_pages:
                ks.append(0)
            else:
                ks.append((n + spec.start) % 8)
                n += 1
        out.append(sorted(ks))
    return out


@pytest.mark.parametrize("seed", [0, 3100000001, 2 ** 33 + 17])
def test_every_seed_sends_the_same_visual_kinds_a_super_batch(seed):
    specs = shelf.plan(mix(), seed, "digital_chapters_llm")
    first = shelf.plan(mix(), 1, "digital_chapters_llm")[0]
    assert len(specs) == 12 and len({s.seed for s in specs}) == 12
    for s in specs:
        assert s.start == 0 and s.pages == 64 and len(s.text_pages) == 26
        assert kinds(s) == kinds(first)
        assert [sum(1 for p in s.text_pages if b0 <= p < b0 + 32) for b0 in (0, 32)] == [13, 13]
    # the text pages still fall where the seed draws them
    assert len({s.text_pages for s in specs}) > 1


def test_the_reference_copy_is_the_tests_plain_reference():
    a = open(os.path.join(REPO, "tests", "mistral4_plain.py"), "rb").read()
    b = open(os.path.join(PB, "reference", "mistral4.py"), "rb").read()
    assert a == b


def test_counts_match_a_hand_count():
    D, H, QL, KVL, R, VD, FW, V = 4096, 32, 1024, 256, 64, 128, 2048, 131072
    attn = 4096 * 1344 + 32 * 128 * 1024 + 32 * 192 * 256 + 4096 * 32 * 128
    assert M.attn_params() == attn == 28_049_408
    assert M.expert_params() == 3 * 2048 * 4096
    # one decode step: 20 sequences attending 30,000 positions in all, 270
    # held experts touched over the 36 layers
    per_layer = 2 * (attn + 3 * FW * D) + 2 * (2 * D + QL + KVL) + 4 * 128 * D \
        + 30_000 * (KVL + R) * 2
    want = 36 * per_layer + 270 * 3 * FW * D * 2 + 20 * D * 2 + D * 2 + V * D * 2
    assert M.decode_bytes(20, 30_000, 270) == want
    # a prefill of two prompts of 1,000 and 300 ids with 1,200 held
    # assignments over the layers
    layer = 2 * 1300 * (attn + 3 * FW * D + 128 * D) + 2 * H * 256 * (1000 ** 2 + 300 ** 2) / 2
    want = 36 * layer + 2 * 1200 * 3 * FW * D + 2 * 2 * V * D
    assert M.prefill_flops(1300, 1000 ** 2 + 300 ** 2, 2, 1200) == pytest.approx(want)
    # one 532 x 532 picture: 38 x 38 patches, 19 x 19 merged cells
    S, E, I = 1444, 1024, 4096
    want = (2 * S * 3 * 196 * E + 24 * (2 * S * (4 * E * E + 3 * E * I) + 4 * S * S * E)
            + 2 * 361 * (4 * E * E + E * D + D * D))
    assert M.vision_flops(S, 1) == pytest.approx(want)


def checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(PB, root / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    return root


@pytest.mark.parametrize("control", [False, True])
def test_the_cell_runs_and_holds_the_program_to_its_reference(tmp_path, monkeypatch,
                                                              control):
    """The cell's configuration and comparison with the model cut to a tiny
    size in float32 on the CPU: the engine serves the pipeline's calls at
    the traffic's lengths, the program agrees with its reference, and the
    fp8 control does not."""
    from portbench.compare import mistral4 as cmp_mod  # noqa: F401  (a copy runs)

    root = checkout(tmp_path)
    p = root / "portbench/configs/textbook_digital_mistral4.json"
    cfg = json.load(open(p))
    cfg["vision_llm"]["args"].update(config=TINY, dtype="float32", pool=4,
                                     held=[0, 1, 2, 3], max_len=2048)
    p.write_text(json.dumps(cfg))
    cmp_path = root / "portbench/compare/mistral4.py"
    cmp_path.write_text(cmp_path.read_text().replace(
        "CONFIG_OVERRIDE = None", f"CONFIG_OVERRIDE = {TINY!r}"))
    bench = json.load(open(root / "BENCHMARK.json"))
    tiny = {"generator": "test_book", "pages": [4], "books": 1, "warmup_pages": 1,
            "batch_pages": 32, "visuals_per_page": 1.0}
    monkeypatch.setattr(shelf, "plan", lambda m, s, name="", root=None: [
        shelf.BookSpec("test_book", 4, 11, 2)])
    out = harness.run_cell(bench, CELL, 2 ** 33 + 5, 0.1, False, device="cpu",
                           workers=2, root=str(root), mix=tiny, control=control)
    checks = {k: v["value"] for k, v in out["checks"].items()}
    limits = cfg["limits"]
    assert checks["llm_failures"] == 0 and checks["books_incomplete"] == 0
    if control:
        assert out["correct"] is False
        assert any(checks[k] > limits[k] for k in
                   ("llm_prefill_gap", "llm_decode_gap", "vision_gap"))
    else:
        assert out["correct"] is True, out["checks"]
        for k in ("llm_prefill_gap", "llm_decode_gap", "vision_gap"):
            assert checks[k] < 1e-4
        assert checks["llm_route_gap"] == 0.0
