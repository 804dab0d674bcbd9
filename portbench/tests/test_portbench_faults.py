"""``correct`` comes out false, under the cells' own limits, for the
control and for each fault a training cell can have, at a tiny size on
the CPU.  The run skips the harness's look for a card and drives the
rest: the program's step with the fault planted underneath.

  control       the reference with TF32 products (emulated: operands
                rounded to 10 mantissa bits) in the program's place
  unchanged     a step that returns its state unchanged
  half_batch    the loss over half the positions, its mean over the rest
  no_exchange   the fresh round's mean left out: client 0's message alone
  stale_key     every fresh round drawing with the first round's key
  frozen_window the window's steps returning their parameters unchanged,
                the prologue's sound

The last two go wrong only once the prologue is over, so only the
comparison of the window's own steps can see them.

One card holds every cell, so no exchange between cards exists to leave
out; the fresh round's mean over the clients is the exchange.
"""
import time

import pytest

from portbench import control
from portbench.harness import cell as cell_run
from portbench.harness import compare, spec
from portbench.tests.tiny import CELLS, one_thread, shrink  # noqa: F401


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    limits = spec.workload(name)["limits"]
    readings = dict(control.readings(name, 2 ** 31 + 41, "cpu", True, True,
                                     0.0, shrink=shrink(name),
                                     matmul="tf32_emulated"))

    def checked(kind):
        return {k: {"value": v, "limit": limits[k]}
                for k, v in readings[kind].items() if k in limits}
    assert compare.correct(checked("program"))
    for kind in ("control",) + control.FAULTS:
        assert not compare.correct(checked(kind)), kind


def _unchanged(monkeypatch):
    from repro_torch.launch import steps
    real = steps.l2gd_step

    def step(state, *args, **kwargs):
        return state, real(state, *args, **kwargs)[1]
    monkeypatch.setattr(steps, "l2gd_step", step)


def _half_batch(monkeypatch):
    from repro_torch.launch import steps
    real = steps.model_loss_fn

    def loss(params, cfg, batch):
        tokens = batch["tokens"]
        return real(params, cfg, {**batch, "tokens":
                                  tokens[..., :tokens.shape[-1] // 2 + 1]})
    monkeypatch.setattr(steps, "model_loss_fn", loss)


def _no_exchange(monkeypatch):
    from repro_torch.core import l2gd
    from repro_torch.core.tree import tree_map
    real = l2gd.compressed_average

    def average(key, params, up, down, mask=None):
        return real(key, tree_map(lambda a: a[:1], params), up, down)
    monkeypatch.setattr(l2gd, "compressed_average", average)


def _stale_key(monkeypatch):
    from repro_torch.core import l2gd
    real, first = l2gd.compressed_average, []

    def average(key, *args, **kwargs):
        first.append(key)
        return real(first[0], *args, **kwargs)
    monkeypatch.setattr(l2gd, "compressed_average", average)


def _frozen_window(monkeypatch):
    from repro_torch.launch import steps
    real = steps.l2gd_step

    def step(state, *args, **kwargs):
        new, metrics = real(state, *args, **kwargs)
        if state.step >= cell_run.PROLOGUE:
            new = new._replace(params=state.params)
        return new, metrics
    monkeypatch.setattr(steps, "l2gd_step", step)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _no_exchange,
                                   _stale_key, _frozen_window])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    _, checks, _, _ = cell_run.run(name, 2 ** 31 + 43, 0.0, False,
                                   start=time.time(), device="cpu",
                                   shrink=shrink(name))
    assert not compare.correct(checks), checks
