"""The benchmark's files: every cell, configuration and metric found by
name, the xi cycles' branch shares, the yardstick's arithmetic at hand
sizes, and no import of JAX or the JAX package."""
import ast
import json
import math
from pathlib import Path

import numpy as np
import pytest

from portbench.harness import compare, roofline, spec
from portbench.harness.cell import forbidden, prologue_xis
from portbench.reference import model
from portbench.tests.tiny import one_thread  # noqa: F401

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_load(name):
    entry = spec.cell_entry(BENCH, name)
    cell = spec.workload(name)
    assert cell["config"] == entry["config"]
    assert entry["chips"] == 1
    cfg = spec.config(cell["config"])
    assert cfg["name"] == cell["config"]
    assert set(cell["limits"]) <= set(compare.NAMES)
    assert {"loss_gap", "grad_gap", "change_gap", "window_loss_gap",
            "target_gap"} <= set(cell["limits"])
    assert {"window_change_gap", "window_change_gap_median"} \
        & set(cell["limits"])
    assert cell["limits"]["bits_gap"] == 0
    assert cell["codec"]["name"] in ("natural", "qsgd")
    assert cell["transport"] in ("leafwise", "flat")
    for m in spec.cell_metrics(BENCH, name, False) \
            + spec.cell_metrics(BENCH, name, True):
        assert m["name"] in METRICS


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_files_match_the_benchmark(name):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    cfg = json.loads((spec.REPO / entry["file"]).read_text())
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert all(k in cfg for k in cfg["reduced"])
    assert cfg["global_batch"] == cfg["clients"] * cfg["batch_per_client"]
    shapes = model.param_shapes(cfg)
    assert sum(math.prod(s) for s in shapes.values()) == \
        cfg["params_per_client"]


@pytest.mark.parametrize("name", METRICS)
def test_every_metric_has_a_reader(name):
    assert callable(spec.reader(name))


def test_a_cell_added_as_a_file_loads(tmp_path):
    cell = json.loads((spec.HERE / "workloads" / f"{CELLS[0]}.json")
                      .read_text())
    cell["xi_cycle"] = [0, 1, 1]
    (tmp_path / "added.json").write_text(json.dumps(cell))
    loaded = spec.workload("added", directory=tmp_path)
    assert loaded["p"] == pytest.approx(2 / 3)
    assert prologue_xis(loaded["xi_cycle"]) == [0, 1, 1]
    bench = {**BENCH, "per_layer": BENCH["per_layer"] + [
        {"name": "x", "workloads": ["added"]}]}
    assert [m["name"] for m in spec.cell_metrics(bench, "added", True)] \
        == ["x"]


@pytest.mark.parametrize("name", CELLS)
def test_cycles_give_the_protocol_shares(name):
    """Through the program's ``window_streams``: local 1 - p, and the
    aggregations p, fresh p (1 - p) and cached p^2 where the cycle has a
    cached step."""
    from repro_torch.core.rollout import window_streams
    cell = spec.workload(name)
    cycle, p = cell["xi_cycle"], cell["p"]
    reps = 8
    xis, keys = window_streams(np.array([0, 7], np.uint32), p, 3,
                               reps * len(cycle), xi_trace=cycle * reps)
    assert len(np.unique(keys, axis=0)) == len(keys)
    prev, counts = 0, [0, 0, 0]
    for xi in xis:
        counts[0 if xi == 0 else 1 if prev == 0 else 2] += 1
        prev = xi
    shares = np.array(counts) / len(xis)
    assert shares[0] == pytest.approx(1 - p)
    assert shares[1] + shares[2] == pytest.approx(p)
    if prologue_xis(cycle)[2] == 1:
        assert shares[1:] == pytest.approx([p * (1 - p), p * p])


def test_yardstick_at_hand_sizes():
    cfg = {"n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1,
           "head_dim": 4, "d_ff": 16, "vocab_size": 10, "ffn": "dense",
           "clients": 3, "batch_per_client": 2, "seq_len": 5}
    shapes = model.param_shapes(cfg)
    # table 80, final norm 8, a layer: q 64, k 32, v 32, o 64, norms 16,
    # MLP 3 x 128
    n_params = 80 + 8 + 2 * (64 + 32 + 32 + 64 + 16 + 384)
    assert sum(math.prod(s) for s in shapes.values()) == n_params
    attention = 2 * 4.0 * 2 * 5 * 5 * 2 * 4 * 0.5
    assert roofline.train_flops(cfg, shapes) == \
        3 * (6.0 * n_params * 2 * 5 + 3 * attention)
    assert roofline.codec_bytes(cfg, shapes) == 4 * 4.0 * n_params
    moe = {**cfg, "ffn": "moe", "n_experts": 4, "experts_per_token": 1,
           "moe_d_ff": 16}
    shapes = model.param_shapes(moe)
    experts = 2 * 3 * 4 * 8 * 16
    total = sum(math.prod(s) for s in shapes.values())
    assert roofline.active_params(moe, shapes) == total - experts * 3 / 4


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


def test_no_jax_and_a_reference_of_its_own():
    files = sorted(spec.HERE.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}, path
    for path in (spec.HERE / "reference").glob("*.py"):
        assert "repro_torch" not in _imports(path), path
    assert forbidden(["jax.numpy", "repro_torch.core", "reprox", "flax",
                      "repro.core", "torch"]) == ["flax", "jax", "repro"]
