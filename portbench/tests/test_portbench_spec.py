"""The benchmark's files: every cell, configuration, plain model and
metric found by name, a configuration added as files only, the parent's
numbers pinned, the xi cycles' branch shares, the yardstick's arithmetic
at hand sizes, and no import of JAX or the JAX package."""
import ast
import hashlib
import json
import math
import time
from pathlib import Path

import numpy as np
import pytest

from portbench.harness import cell as cell_run
from portbench.harness import compare, inputs, roofline, spec
from portbench.harness.cell import forbidden, prologue_xis
from portbench.reference import model
from portbench.tests.tiny import MOE, SHRINK, one_thread  # noqa: F401

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
    shapes = spec.reference(cfg).param_shapes(cfg)
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


def _added(root: Path, skew: bool) -> tuple:
    """A configuration added as files only under ``root``: a copy of
    ``reference/model.py`` as ``plain.py`` (its loss scaled by 1.001 where
    ``skew``), stablelm-1.6b's file naming it, and the first cell's file
    on that configuration.  (configs, references, workloads)."""
    dirs = tuple(root / d for d in ("configs", "reference", "workloads"))
    for d in dirs:
        d.mkdir()
    source = (spec.HERE / "reference" / "model.py").read_text()
    scaled = source.replace("return ce + ", "return 1.001 * ce + ")
    assert scaled != source
    (dirs[1] / "plain.py").write_text(scaled if skew else source)
    cfg = {**spec.config("stablelm-1.6b"), "name": "added",
           "reference": "plain"}
    (dirs[0] / "added.json").write_text(json.dumps(cfg))
    cell = json.loads((spec.HERE / "workloads" / f"{CELLS[0]}.json")
                      .read_text())
    (dirs[2] / "added.json").write_text(json.dumps({**cell,
                                                    "config": "added"}))
    return dirs


@pytest.mark.parametrize("skew", [False, True])
def test_a_configuration_added_as_files_runs(tmp_path, skew):
    """The run takes the model the new file names: the copy reads correct
    at a tiny size on the CPU, and a copy whose loss is off by 1e-3 does
    not."""
    configs, references, workloads = _added(tmp_path, skew)
    cell = spec.workload("added", directory=workloads)
    run, checks, attempted, failed = cell_run.run(
        "added", 2 ** 31 + 23, 0.0, False, start=time.time(), device="cpu",
        shrink=SHRINK, cell=cell, configs=configs, references=references)
    assert spec.reference(run.config, references).__file__ == \
        str(references / "plain.py")
    assert failed == 0 and attempted == len(cell["xi_cycle"])
    assert compare.correct(checks) is not skew, checks
    assert (checks["loss_gap"]["value"] > 1e-4) is skew


def _other(value):
    if isinstance(value, bool):
        return not value
    return value + ("x" if isinstance(value, str) else 1)


STABLELM = spec.config("stablelm-1.6b")


@pytest.mark.parametrize("key", [k for k in model.MODEL_KEYS
                                 if k in STABLELM])
def test_program_config_holds_the_file_to_each_model_key(key):
    with pytest.raises(ValueError, match=key):
        cell_run.program_config({**STABLELM, key: _other(STABLELM[key])})


def test_program_config_holds_no_key_outside_the_models(tmp_path):
    """A plain model that reads two fields: the program is held to the
    file on those alone, and a test's cuts of the others are not applied."""
    (tmp_path / "narrow.py").write_text(
        'MODEL_KEYS = ("n_layers", "d_model")\n')
    cfg = {**STABLELM, "reference": "narrow", "n_heads": 31}
    with pytest.raises(ValueError, match="d_model"):
        cell_run.program_config({**cfg, "d_model": 2047},
                                references=tmp_path)
    prog = cell_run.program_config(cfg, {"n_layers": 1, "n_heads": 4},
                                   references=tmp_path)
    assert (prog.n_layers, prog.d_model, prog.n_heads) == (1, 2048, 32)
    with pytest.raises(KeyError, match="no reference"):
        cell_run.program_config({k: v for k, v in STABLELM.items()
                                 if k != "reference"})


#: the parent's numbers, written out: at full size each leaf's shape, the
#: FLOPs of a local step of both clients, the codec's least bytes and each
#: leaf's weight scale; the sha256 of client 0's weights (seed 2^31 + 5)
#: at the tests' tiny size on the CPU (at full size they take 8.6 GB and
#: 25 s of one core)
PINNED = {
    "stablelm-1.6b": {
        "shapes": {"embed.table": (100352, 2048), "final_norm.scale": (2048,),
                   "layers.attn.wk": (24, 2048, 2048),
                   "layers.attn.wo": (24, 2048, 2048),
                   "layers.attn.wq": (24, 2048, 2048),
                   "layers.attn.wv": (24, 2048, 2048),
                   "layers.ffn.w_down": (24, 5632, 2048),
                   "layers.ffn.w_gate": (24, 2048, 5632),
                   "layers.ffn.w_up": (24, 2048, 5632),
                   "layers.ln1.scale": (24, 2048),
                   "layers.ln2.scale": (24, 2048)},
        "train_flops": 80612878712832.0,
        "codec_bytes": 17264959488.0,
        "std": {"embed.table": 0.02, "final_norm.scale": 0.0,
                "layers.attn.wk": 2048 ** -0.5, "layers.attn.wo": 2048 ** -0.5,
                "layers.attn.wq": 2048 ** -0.5, "layers.attn.wv": 2048 ** -0.5,
                "layers.ffn.w_down": 5632 ** -0.5,
                "layers.ffn.w_gate": 2048 ** -0.5,
                "layers.ffn.w_up": 2048 ** -0.5, "layers.ln1.scale": 0.0,
                "layers.ln2.scale": 0.0},
        "weights": "ecae71ee41c97478cedff20e3504d994"
                   "ccdb7a768147a87e47d8c3ce9c4334fd",
    },
    "granite-moe-1b-a400m": {
        "shapes": {"embed.table": (49155, 1024), "final_norm.scale": (1024,),
                   "layers.attn.wk": (24, 1024, 512),
                   "layers.attn.wo": (24, 1024, 1024),
                   "layers.attn.wq": (24, 1024, 1024),
                   "layers.attn.wv": (24, 1024, 512),
                   "layers.ffn.router": (24, 1024, 32),
                   "layers.ffn.w_down": (24, 32, 512, 1024),
                   "layers.ffn.w_gate": (24, 32, 1024, 512),
                   "layers.ffn.w_up": (24, 32, 1024, 512),
                   "layers.ln1.scale": (24, 1024),
                   "layers.ln2.scale": (24, 1024)},
        "train_flops": 26017234157568.0,
        "codec_bytes": 16015540224.0,
        "std": {"embed.table": 0.02, "final_norm.scale": 0.0,
                "layers.attn.wk": 1024 ** -0.5, "layers.attn.wo": 1024 ** -0.5,
                "layers.attn.wq": 1024 ** -0.5, "layers.attn.wv": 1024 ** -0.5,
                "layers.ffn.router": 1024 ** -0.5,
                "layers.ffn.w_down": 512 ** -0.5,
                "layers.ffn.w_gate": 1024 ** -0.5,
                "layers.ffn.w_up": 1024 ** -0.5, "layers.ln1.scale": 0.0,
                "layers.ln2.scale": 0.0},
        "weights": "ebf6d851caa5bf9a53cccff42a878015"
                   "d3e3fc4a2a64441a1d67fb82e6bf2db4",
    },
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_lookup_gives_the_parents_numbers(name):
    pinned, cfg = PINNED[name], spec.config(name)
    ref = spec.reference(cfg)
    shapes = ref.param_shapes(cfg)
    assert list(shapes) == sorted(pinned["shapes"])
    assert shapes == pinned["shapes"]
    assert ref.train_flops(cfg, shapes) == pinned["train_flops"]
    assert roofline.codec_bytes(cfg, shapes) == pinned["codec_bytes"]
    std = inputs.weight_rule(ref)
    assert {k: std(k, s) for k, s in shapes.items()} == pinned["std"]
    tiny = {**cfg, **SHRINK, **(MOE if cfg["ffn"] == "moe" else {})}
    weights = inputs.client_weights(ref.param_shapes(tiny), 2 ** 31 + 5, 0,
                                    "cpu", std)
    digest = hashlib.sha256()
    for leaf in weights.values():
        digest.update(leaf.contiguous().numpy().tobytes())
    assert digest.hexdigest() == pinned["weights"]


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
    assert model.train_flops(cfg, shapes) == \
        3 * (6.0 * n_params * 2 * 5 + 3 * attention)
    assert roofline.codec_bytes(cfg, shapes) == 4 * 4.0 * n_params
    moe = {**cfg, "ffn": "moe", "n_experts": 4, "experts_per_token": 1,
           "moe_d_ff": 16}
    shapes = model.param_shapes(moe)
    experts = 2 * 3 * 4 * 8 * 16
    total = sum(math.prod(s) for s in shapes.values())
    assert model.active_params(moe, shapes) == total - experts * 3 / 4


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
    plain = sorted((spec.HERE / "reference").rglob("*.py"))
    assert spec.HERE / "reference" / "model.py" in plain
    for path in plain:
        assert not _imports(path) & {"jax", "jaxlib", "flax", "repro",
                                     "repro_torch"}, path
    assert forbidden(["jax.numpy", "repro_torch.core", "reprox", "flax",
                      "repro.core", "torch"]) == ["flax", "jax", "repro"]
