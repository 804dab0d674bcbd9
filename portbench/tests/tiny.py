"""Sizes at which the CPU tests run a cell: every width cut, one layer,
32 tokens a client; the experts four, two a token."""
import pytest
import torch

from portbench.harness import spec

SHRINK = {"n_layers": 1, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
          "head_dim": 16, "d_ff": 96, "vocab_size": 256, "seq_len": 32}
MOE = {"n_experts": 4, "experts_per_token": 2, "moe_d_ff": 32}
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def shrink(cell: str) -> dict:
    moe = spec.config(spec.workload(cell)["config"])["ffn"] == "moe"
    return {**SHRINK, **(MOE if moe else {})}


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: the suite runs in parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
