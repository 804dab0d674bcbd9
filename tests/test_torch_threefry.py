"""The threefry array draws' dispatch (``core.prng._draw``) and the
``threefry_draw`` kernel's wrapper and source, on the CPU.

The kernel itself runs only on the card (``chip_smoke.py`` holds it bit
for bit to its plain version there).  Here: the CPU runs the plain
version and launches nothing; any other device raises; the draw's
checks; the plain version at counters whose high word is not 0 against
numpy's ``prng.threefry2x32`` on the same counters (the high-word path
the kernel reproduces); the route a CUDA output takes, with the launch
stood in for; the library and the kernel's names; the source's key
schedule against ``prng``'s.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from _torch_threads import torch_one_thread  # noqa: F401
from repro_torch.core import prng
from repro_torch.kernels import build
from repro_torch.kernels.dispatch import LAUNCHES
from repro_torch.kernels.threefry import kernel as threefry

U32 = np.uint32
SOURCE = pathlib.Path(build.__file__).parent / build.SOURCES["threefry"]
KEYS = prng.split(prng.PRNGKey(11), 3)


def _numpy_draw(keys, offset, total):
    """y1 ^ y2 of the counters offset .. offset + total - 1, (batch, total)."""
    count = np.arange(total, dtype=np.uint64) + np.uint64(offset)
    hi = (count >> np.uint64(32)).astype(U32)
    lo = (count & np.uint64(0xFFFFFFFF)).astype(U32)
    keys = np.asarray(keys, U32).reshape(-1, 2)
    y1, y2 = prng.threefry2x32(keys[:, 0, None], keys[:, 1, None], hi, lo)
    return y1 ^ y2


def _uniform(bits):
    return ((bits >> U32(9)).astype(np.float32)
            * np.float32(1.0 / (1 << 23)))


def test_cpu_runs_the_plain_version_without_launching():
    before = dict(LAUNCHES)
    prng.tensor_bits(KEYS, (5, 7), "cpu")
    prng.tensor_uniform(KEYS, (40,), "cpu", offset=3)
    prng.tensor_bernoulli(KEYS[0], 0.3, (9,), "cpu")
    prng.tensor_normal(KEYS[1], (4, 4), "cpu")
    prng.permutation(KEYS, 50, "cpu")
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize("draw", ["bits", "uniform", "bernoulli", "normal"])
def test_non_cpu_non_cuda_device_raises(draw):
    """A draw on a device that is neither the CPU nor CUDA has no kernel
    and no plain version: it raises instead of drawing elsewhere."""
    calls = {"bits": lambda: prng.tensor_bits(KEYS, (8,), "meta"),
             "uniform": lambda: prng.tensor_uniform(KEYS, (8,), "meta"),
             "bernoulli": lambda: prng.tensor_bernoulli(KEYS, 0.5, (8,),
                                                        "meta"),
             "normal": lambda: prng.tensor_normal(KEYS, (8,), "meta")}
    with pytest.raises(ValueError, match="no kernel"):
        calls[draw]()


@pytest.mark.parametrize("bad", ["key (3,)", "keys (2, 3)", "offset -1",
                                 "past 2^64"])
def test_draw_input_checks(bad):
    call = {"key (3,)": lambda: prng.tensor_uniform(np.zeros(3, U32), (4,)),
            "keys (2, 3)": lambda: prng.tensor_bits(np.zeros((2, 3), U32),
                                                    (4,)),
            "offset -1": lambda: prng.tensor_uniform(KEYS, (4,), offset=-1),
            "past 2^64": lambda: prng.tensor_bernoulli(
                KEYS, 0.5, (4, 4), offset=2 ** 64 - 15)}[bad]
    with pytest.raises(ValueError):
        call()


def test_draw_ends_at_the_last_counter():
    got = prng.tensor_uniform(KEYS, (4, 4), offset=2 ** 64 - 16)
    np.testing.assert_array_equal(
        got.numpy().reshape(3, 16), _uniform(_numpy_draw(KEYS, 2 ** 64 - 16,
                                                         16)))


@pytest.mark.parametrize("offset", [2 ** 32 - 37, 2 ** 32, 5 * 2 ** 32 + 11,
                                    2 ** 63 - 20])
@pytest.mark.parametrize("finish", ["bits", "uniform", "bernoulli"])
def test_draws_across_the_high_word_equal_numpy(offset, finish, monkeypatch):
    """Counters whose high word is not 0, and a chunk that crosses into
    the next high word: the plain version equals numpy's threefry2x32 on
    the same counters, in each finish, for one key and a batch."""
    monkeypatch.setattr(prng, "DRAW_CHUNK", 32)
    shape = (3, 25)
    for keys in (KEYS, KEYS[2]):
        want = _numpy_draw(keys, offset, 75)
        if finish == "bits":
            got = prng._draw(keys, shape, None, "bits", offset).numpy() \
                .astype(U32)
        elif finish == "uniform":
            got = prng.tensor_uniform(keys, shape, offset=offset).numpy()
            want = _uniform(want)
        else:
            got = prng.tensor_bernoulli(keys, 0.3, shape,
                                        offset=offset).numpy()
            want = _uniform(want) < np.float32(0.3)
        np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_cuda_output_goes_to_the_kernel_alone(monkeypatch):
    """The route of a CUDA output, with the launch stood in for: each
    array draw calls ``threefry_draw`` once, with the keys as (batch, 2)
    rows, the whole (batch, total) output, the offset, the finish and
    bernoulli's float32 p, and never the plain int64 version."""
    calls = []

    def kernel(keys, out, offset, finish, p=0.0):
        calls.append((keys.shape, tuple(out.shape), out.dtype, offset,
                      finish, p))
        out.zero_()

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA draw reached the plain version")

    monkeypatch.setattr(prng, "use_kernel", lambda *t: True)
    monkeypatch.setattr(prng.threefry, "threefry_draw", kernel)
    monkeypatch.setattr(prng, "_draw_plain", plain)
    prng.tensor_bits(KEYS, (4, 5))
    prng.tensor_uniform(KEYS[0], (6,), offset=2 ** 40)
    prng.tensor_bernoulli(KEYS, 0.1, (7,), offset=9)
    prng.tensor_normal(KEYS[1], (2, 3))
    p32 = float(np.float32(0.1))
    assert calls == [((3, 2), (3, 20), torch.int64, 0, "bits", 0.0),
                     ((1, 2), (1, 6), torch.float32, 2 ** 40, "uniform", 0.0),
                     ((3, 2), (3, 7), torch.bool, 9, "bernoulli", p32),
                     ((1, 2), (1, 6), torch.float32, 0, "uniform", 0.0)]
    calls.clear()
    prng.permutation(KEYS, 1626)        # two sort rounds: two draws
    assert [c[:2] for c in calls] == [((3, 2), (3, 1626))] * 2


def test_wrapper_launches_on_cuda_only():
    with pytest.raises(ValueError, match="CUDA"):
        threefry.threefry_draw(KEYS, torch.empty(3, 5), 0, "uniform")
    with pytest.raises(KeyError):
        threefry.threefry_draw(KEYS, torch.empty(3, 5), 0, "normal")


def test_build_names_the_library_and_the_kernel_stays_off_codec_names():
    """The library is built as ``threefry``; its entry point and kernels
    are named ``threefry_*``, outside the codec kernels' prefixes (which
    the benchmark's ``codec_roofline`` times by name)."""
    assert build.SOURCES["threefry"] == "threefry/csrc/threefry.cu"
    text = SOURCE.read_text()
    entries = re.findall(r"^int (\w+)\(", text, re.M)
    kernels = re.findall(r"__global__ void __launch_bounds__\(\w+\)\s+(\w+)\(",
                         text)
    assert entries == ["threefry_draw"] and kernels == ["threefry_kernel"]
    for name in entries + kernels:
        assert name.startswith("threefry_")
        assert not name.startswith(("qsgd_", "natural_"))


def test_source_key_schedule_is_prngs():
    """The source's rotations, parity and injections are
    ``prng.threefry2x32``'s: five groups of four rotations alternating
    from ``_ROTATIONS``, then ``x0 += ks[(i + 1) % 3]`` and ``x1 +=
    ks[(i + 2) % 3] + i + 1``."""
    text = SOURCE.read_text()
    body = text[text.index("uint32_t threefry_xor("):]
    body = body[:body.index("\n}\n")]
    groups = [tuple(int(r) for r in g.split(","))
              for g in re.findall(r"four\(x0, x1, ([\d, ]+)\)", body)]
    assert groups == [prng._ROTATIONS[i % 2] for i in range(5)]
    assert f"0x{int(prng._PARITY):08X}u" in text
    sched = re.search(r"return \{(k0, k1, k2, [^}]*)\}", text).group(1)
    names = [w.strip() for w in sched.split(",")]
    ks = ["k0", "k1", "k2"]
    assert names[3:] == [f"{ks[(i + 2) % 3]} + {i + 1}u" for i in range(5)]
    adds = re.findall(r"x0 \+= s\.(k\d);\s*x1 \+= s\.(\w+);", body)
    assert adds == [("k0", "k1")] + [(ks[(i + 1) % 3], f"i{i + 1}")
                                     for i in range(5)]
