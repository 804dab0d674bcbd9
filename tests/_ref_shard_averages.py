"""The reference's per-shard averages on two forced host devices, for
tests/test_torch_sharded.py: run as a script with
``XLA_FLAGS=--xla_force_host_platform_device_count=2``; reads the inputs
from the .npz named by argv[1] and writes the outputs to argv[2].

The same cases as ``_torch_ranks.shard_averages``: packed QSGD and packed
natural payloads on the all_gather, the stochastic bf16 wire, and
compressed_average_wire with one client a device; and each device's
packed QSGD message (codes and norms) as the payload average builds it."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from repro.core import make_compressor, make_plan
from repro.core.aggregation import (_shard_map, compressed_average_wire,
                                    make_payload_sharded_average,
                                    make_sharded_average)
from repro.launch.mesh import make_client_mesh


def main(src, dst):
    inputs = np.load(src)
    params = {"w": jnp.asarray(inputs["params"])}
    key = jax.random.wrap_key_data(jnp.asarray(inputs["key"]))
    d = params["w"].shape[1]
    mesh = make_client_mesh(2)
    spec = {"w": P("clients", None)}
    out = {}
    with mesh:
        for name in ("qsgd", "natural"):
            plan = make_plan(make_compressor(name), {"w": jnp.zeros(d)},
                             transport="packed")
            fn = make_payload_sharded_average(
                mesh, ("clients",), spec, make_compressor("identity"), plan)
            out["payload_" + name] = np.asarray(jax.jit(fn)(key, params)["w"])
        fn = make_sharded_average(mesh, ("clients",), spec,
                                  make_compressor("natural"))
        out["wire"] = np.asarray(jax.jit(fn)(key, params)["w"])

        def one(k, p):
            return compressed_average_wire(
                k, {"w": p[0]}, make_compressor("identity"), "clients")["w"]

        f = _shard_map(one, mesh=mesh, in_specs=(P(), P("clients", None)),
                       out_specs=P())
        out["wire_one"] = np.asarray(jax.jit(f)(key, params["w"][:2]))

        plan = make_plan(make_compressor("qsgd"), {"w": jnp.zeros(d)},
                         transport="packed")

        def qsgd_message(k, p):
            # make_payload_sharded_average's uplink message, as its
            # shard_map builds it
            k_up = jax.random.fold_in(jax.random.split(k)[0],
                                      jax.lax.axis_index("clients"))
            pay = plan.encode(k_up, {"w": jnp.mean(p.astype(jnp.float32),
                                                   axis=0)})
            return pay.codes[None], pay.norms[None]

        f = _shard_map(qsgd_message, mesh=mesh,
                       in_specs=(P(), P("clients", None)),
                       out_specs=(P("clients"), P("clients")))
        codes, norms = jax.jit(f)(key, params["w"])
        out["qsgd_codes"], out["qsgd_norms"] = np.asarray(codes), \
            np.asarray(norms)
    np.savez(dst, **out)


if __name__ == "__main__":
    assert len(jax.devices()) == 2, jax.devices()
    main(sys.argv[1], sys.argv[2])
