"""The reference against the port at a tiny size on the CPU: the codecs
and the compressed average bit for bit, the wire bits at full size, and
whole runs of every cell correct under the cell's own limits."""
import time

import numpy as np
import pytest
import torch

from portbench.harness import cell as cell_run
from portbench.harness import compare, inputs, spec
from portbench.reference import codecs, draws
from portbench.tests.tiny import (CELLS, MOE, SHRINK, one_thread,  # noqa: F401
                                  shrink)

CODECS = [({"name": "natural"}, "leafwise"), ({"name": "natural"}, "flat"),
          ({"name": "qsgd", "levels": 127}, "leafwise"),
          ({"name": "qsgd", "levels": 127}, "flat")]


def _plan(codec, transport, shapes):
    from repro_torch.core import make_compressor, make_plan
    comp = make_compressor(codec["name"], **{k: v for k, v in codec.items()
                                             if k != "name"})
    return make_plan(comp, shapes, transport=transport)


@pytest.mark.parametrize("codec,transport", CODECS)
def test_compressed_average_bit_for_bit(codec, transport):
    from repro_torch.core.aggregation import compressed_average
    shapes = {"a.w": (3, 70, 50), "b.scale": (33,), "c.table": (130, 20)}
    x = {k: torch.randn((2,) + s, generator=torch.Generator().manual_seed(i))
         for i, (k, s) in enumerate(shapes.items())}
    key = draws.fold_in(draws.key_of(2 ** 31 + 99), 5)
    plan = _plan(codec, transport, {k: torch.empty(s, device="meta")
                                    for k, s in shapes.items()})
    want = inputs.dotted(compressed_average(key, inputs.nested(x), plan,
                                            plan))
    got = codecs.compressed_average(codec, transport, key,
                                    [x[k] for k in sorted(x)])
    for name, value in zip(sorted(x), got):
        assert torch.equal(value, want[name]), name


def test_step_keys_are_the_programs():
    from repro_torch.core.rollout import window_streams
    key = draws.key_of(3 * 2 ** 31 + 5)
    _, want = window_streams(key, 0.5, 4, 6, xi_trace=[0, 1] * 3)
    assert np.array_equal(draws.step_keys(key, 4, 6), want)


@pytest.mark.parametrize("codec,transport", CODECS)
@pytest.mark.parametrize("config", ["stablelm-1.6b", "granite-moe-1b-a400m"])
def test_round_bits_at_full_size(config, codec, transport):
    from repro_torch.launch.steps import param_shapes
    cfg = spec.config(config)
    prog = cell_run.program_config(cfg)
    shapes = spec.reference(cfg).param_shapes(cfg)
    assert codecs.round_bits(codec, transport, list(shapes.values())) == \
        _plan(codec, transport, param_shapes(prog)).round_bits()


@pytest.mark.parametrize("name", CELLS)
def test_cell_correct_at_tiny_size(name):
    run, checks, attempted, failed = cell_run.run(
        name, 2 ** 31 + 17, 0.0, False, start=time.time(), device="cpu",
        shrink=shrink(name))
    assert compare.correct(checks), checks
    assert failed == 0 and attempted == len(spec.workload(name)["xi_cycle"])
    assert checks["bits_gap"]["value"] == 0
    assert checks["loss_gap"]["value"] < 1e-5
    prev, want = cell_run.prologue_xis(run.cell["xi_cycle"])[-1], []
    for xi in run.cell["xi_cycle"]:
        want.append(0 if xi == 0 else 1 if prev == 0 else 2)
        prev = xi
    assert run.branches == want


@pytest.mark.parametrize("codec,transport", CODECS)
def test_moe_run_matches_the_reference_at_tiny_size(codec, transport):
    """The mixture of experts (granite-moe-1b-a400m's layers, cut to a
    tiny size), which no cell runs: the whole run of a cell on it, at
    the protocol's most communicating mix, against the reference."""
    cell = {"config": "granite-moe-1b-a400m", "codec": codec,
            "transport": transport, "xi_cycle": [0, 0, 1, 1], "p": 0.5,
            "eta": 0.1, "lam": 0.5, "token_noise": 0.05, "name": "moe",
            "limits": {"loss_gap": 1e-6, "grad_gap": 1e-5,
                       "change_gap": 1e-6, "window_loss_gap": 1e-6,
                       "window_change_gap": 1e-6, "target_gap": 1e-6,
                       "bits_gap": 0}}
    _, checks, attempted, failed = cell_run.run(
        "moe", 2 ** 31 + 19, 0.0, False, start=time.time(), device="cpu",
        shrink={**SHRINK, **MOE}, cell=cell)
    assert compare.correct(checks), checks
    assert failed == 0 and attempted == 4
