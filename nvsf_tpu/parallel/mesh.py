"""Device mesh + ray-sharded data parallelism.

The reference's distribution story is vestigial DDP scaffolding
(``trainer.py:82-84,1506-1524``; never exercised). Here parallelism is
a 1-D ``jax.sharding.Mesh`` over the 'data' axis; the per-step ray batch is
shard-annotated along rays, parameters are replicated, and XLA's SPMD
partitioner inserts the gradient all-reduce (NCCL over NVLink on GPUs) —
the direct analogue of DDP all-reduce, but compiled into the step.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` (default: all)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def mesh_from_spec(spec: str) -> Mesh:
    """Parse a 'mesh_shape' config string like '8' or '4x2' (extra axes are
    currently folded into the data axis — the model is small enough that
    replication is the right layout)."""
    if not spec:
        return make_mesh()
    dims = [int(x) for x in spec.lower().split("x")]
    return make_mesh(int(np.prod(dims)))


def shard_rays(mesh: Mesh, *arrays):
    """Constrain leading (ray) dimension sharding to the data axis."""
    sh = NamedSharding(mesh, P(DATA_AXIS))
    return tuple(jax.lax.with_sharding_constraint(a, sh) for a in arrays)


def replicate(mesh: Mesh, tree):
    """Fully-replicated placement for params / small state."""
    sh = NamedSharding(mesh, P())
    return jax.device_put(tree, sh)


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def data_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(DATA_AXIS))


def sample_shard_hint(mesh: Mesh):
    """Constraint callback for flat per-sample tensors (leading axis =
    rays x samples). Re-asserting the data sharding at the renderer's
    flatten points keeps the SPMD partitioner from replicating encoder
    activations mid-chain: without it, the backward of the sample-axis
    reshapes all-gathered every plane/hash gather output (~120 MB of
    all-gathers per 1024+1024-ray step in the CPU-mesh HLO)."""
    def hint(a):
        if getattr(a, "ndim", 0) == 0 or a.shape[0] % mesh.size != 0:
            return a
        spec = P(DATA_AXIS, *([None] * (a.ndim - 1)))
        return jax.lax.with_sharding_constraint(
            a, NamedSharding(mesh, spec))
    return hint


_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8,
                "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1}


def collective_stats(compiled, per_op: bool = False) -> dict:
    """Collective-op counts + payload bytes from a compiled executable's
    HLO — the comm evidence for the sharded step (SURVEY §2.3: grads ride
    an all-reduce; eval gathers mirror ``trainer.py:1506-1524``).

    Returns {op_kind: {"count": n, "bytes": payload}} for all-reduce /
    all-gather / reduce-scatter / collective-permute / all-to-all, plus
    per-device flops under "flops". With ``per_op=True`` also returns
    "ops": a list of {kind, bytes, op_name} — op_name is the XLA metadata
    trail back to the producing JAX op, attributing each collective to its
    source tensor (error-map scatter, chamfer points, flow batch, ...)."""
    import re

    text = compiled.as_text()
    stats = {}
    ops = []
    pat = re.compile(
        r"^\s*(?:ROOT\s+)?\S+\s*=\s*((?:\([^)]*\)|\S+?))\s+"
        r"(all-reduce|all-gather|reduce-scatter|collective-permute|"
        r"all-to-all)(?:-start)?\((?:[^\n]*?"
        r"metadata=\{[^}]*?op_name=\"([^\"]*)\")?", re.M)
    for m in pat.finditer(text):
        shape_s, kind, op_name = m.group(1), m.group(2), m.group(3)
        # async '-start' ops have TUPLE result shapes (operand alias +
        # result [+ context tokens]); summing the elements double-counts
        # the payload, so count the LARGEST element (= the moved buffer)
        elems = []
        for dt, dims in re.findall(r"(\w+)\[([\d,]*)\]", shape_s):
            if dt not in _DTYPE_BYTES:
                continue
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            elems.append(n * _DTYPE_BYTES[dt])
        if shape_s.startswith("("):
            nbytes = max(elems, default=0)
        else:
            nbytes = sum(elems)
        ent = stats.setdefault(kind, {"count": 0, "bytes": 0})
        ent["count"] += 1
        ent["bytes"] += nbytes
        if per_op:
            ops.append({"kind": kind, "bytes": nbytes,
                        "op_name": op_name or ""})
    cost = compiled.cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    stats["flops"] = float(cost.get("flops", 0.0)) if cost else 0.0
    if per_op:
        stats["ops"] = ops
    return stats


def aggregate_collectives(ops, top: int = None):
    """Group collective_stats(per_op=True)['ops'] rows by (kind, cleaned
    op_name suffix), sorted by payload bytes — the shared attribution
    formatter used by __graft_entry__.dryrun_multichip."""
    import re

    def clean(op_name):
        parts = [p for p in op_name.split("/")
                 if p and not p.startswith("jit(")]
        tail = "/".join(parts[-3:]) if parts else op_name
        return re.sub(r"\[[^\]]*\]", "", tail)

    agg = {}
    for op in ops:
        key = (op["kind"], clean(op["op_name"]))
        ent = agg.setdefault(key, {"count": 0, "bytes": 0})
        ent["count"] += 1
        ent["bytes"] += op["bytes"]
    rows = sorted(agg.items(), key=lambda kv: -kv[1]["bytes"])
    return rows[:top] if top else rows
