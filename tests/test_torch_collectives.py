"""The port's collectives (``horovod_tpu_torch.ops.collectives``) against
the JAX package's in-jit collectives, rank by rank.

The same per-rank inputs, drawn from a seed with numpy, go through a
gloo world of N processes (one world per N, run once for the file by a
module fixture) and through ``horovod_tpu.ops.collectives`` under
``shard_map`` on an N-device dp mesh of the test platform's virtual
CPU devices, for N = 2 and 4.

Inputs are drawn from [1, 2) so sums and products do not cancel; the
two sides then differ only in the order of f32 additions, well inside
rtol 1e-6. Gathers, broadcasts, permutations and min/max are exact.

The gloo workers run this file as a script (``--worker``), so they load
torch, numpy and the port only: no JAX, no ``conftest.py``.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, ROOT)

from horovod_tpu_torch.common import ops_enum  # noqa: E402
from horovod_tpu_torch.ops import collectives as tc  # noqa: E402

SIZES = (2, 4)
_OPS = ("Average", "Sum", "Min", "Max", "Product")
_SCALES = {"prescale_factor": 0.5, "postscale_factor": 3.0}

CASES = (
    [f"allreduce-{op}" for op in _OPS]
    + [f"allreduce-{op}-scaled" for op in _OPS]
    + ["allreduce-int-average-raises", "grouped-Average",
       "allgather-axis0", "allgather-axis1",
       "broadcast-root1", "broadcast-root1-bool",
       "alltoall-split0-concat1", "alltoall-split1-concat0",
       "reducescatter-Sum", "reducescatter-Average",
       "reducescatter-Average-axis1",
       "ring_permute-shift+1", "ring_permute-shift-1"])


def _inputs(case, n):
    """Every rank's input of ``case``: an array (or dict of arrays)
    with a leading dim of n, row r for rank r."""
    rng = np.random.default_rng(CASES.index(case))

    def u(*shape):
        return rng.uniform(1.0, 2.0, (n,) + shape).astype(np.float32)

    if case.startswith("allreduce-int"):
        return rng.integers(0, 9, (n, 5)).astype(np.int32)
    if case.startswith("grouped"):
        return {"a": u(3, 4), "b": u(5), "c": u(2, 2, 2)}
    if case.endswith("-bool"):
        return rng.integers(0, 2, (n, 6, 3)).astype(bool)
    if case.startswith("alltoall"):
        return u(8, 12)
    if case.endswith("axis1") and case.startswith("reducescatter"):
        return u(3, 8)
    if case.startswith("reducescatter"):
        return u(8, 3)
    return u(6, 3)


def _port(case, x):
    """This rank's result of ``case`` through the port."""
    if case.startswith("allreduce-int"):
        try:
            tc.allreduce(x, ops_enum.Average)
        except TypeError as e:
            return f"TypeError: {e}"
        return "no error"
    kind, *rest = case.split("-")
    if kind == "allreduce":
        kw = _SCALES if rest[1:] == ["scaled"] else {}
        return tc.allreduce(x, getattr(ops_enum, rest[0]), **kw)
    if kind == "grouped":
        return tc.grouped_allreduce(x, ops_enum.Average)
    if kind == "allgather":
        return tc.allgather(x, axis=int(rest[0][-1]))
    if kind == "broadcast":
        return tc.broadcast(x, root_rank=1)
    if kind == "alltoall":
        return tc.alltoall(x, split_axis=int(rest[0][-1]),
                           concat_axis=int(rest[1][-1]))
    if kind == "reducescatter":
        return tc.reducescatter(x, getattr(ops_enum, rest[0]),
                                scatter_axis=1 if rest[1:] else 0)
    return tc.ring_permute(x, shift=int(case.rsplit("shift", 1)[1]))


def _jax(case, xs, n):
    """Every rank's result of ``case`` through the JAX package, stacked
    on a leading dim of n."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from horovod_tpu.common import ops_enum as jops
    from horovod_tpu.common.jax_compat import shard_map
    from horovod_tpu.ops import collectives as jc
    from horovod_tpu.parallel import build_mesh

    kind, *rest = case.split("-")

    def body(x):
        if case.startswith("allreduce-int"):
            return jc.allreduce(x, jops.Average, "dp")
        if kind == "allreduce":
            kw = _SCALES if rest[1:] == ["scaled"] else {}
            return jc.allreduce(x, getattr(jops, rest[0]), "dp", **kw)
        if kind == "grouped":
            return jc.grouped_allreduce(x, jops.Average, "dp")
        if kind == "allgather":
            return jc.allgather(x, "dp", axis=int(rest[0][-1]))
        if kind == "broadcast":
            return jc.broadcast(x, root_rank=1, axis_name="dp")
        if kind == "alltoall":
            return jc.alltoall(x, "dp", split_axis=int(rest[0][-1]),
                               concat_axis=int(rest[1][-1]))
        if kind == "reducescatter":
            return jc.reducescatter(x, getattr(jops, rest[0]), "dp",
                                    scatter_axis=1 if rest[1:] else 0)
        return jc.ring_permute(x, "dp", shift=int(case.rsplit("shift", 1)[1]))

    def per_shard(x):
        y = body(jax.tree.map(lambda a: a[0], x))
        return jax.tree.map(lambda a: a[None], y)

    mesh = build_mesh(devices=jax.devices()[:n], dp=n)
    f = jax.jit(shard_map(per_shard, mesh=mesh, in_specs=(P("dp"),),
                          out_specs=P("dp"), check_vma=False))
    try:
        return jax.tree.map(np.asarray, f(jax.tree.map(jnp.asarray, xs)))
    except TypeError as e:
        return f"TypeError: {e}"


def _worker(store, out):
    import torch.distributed as dist

    from horovod_tpu_torch.parallel.mesh import init_process_group

    init_process_group("cpu", init_method=f"file://{store}", timeout=120)
    rank, size = dist.get_rank(), dist.get_world_size()
    results = {}
    for case in CASES:
        xs = _inputs(case, size)
        x = (
            {k: torch.from_numpy(v[rank]) for k, v in xs.items()}
            if isinstance(xs, dict) else torch.from_numpy(xs[rank]))
        y = _port(case, x)
        results[case] = (y if isinstance(y, str) else
                         {k: v.numpy() for k, v in y.items()}
                         if isinstance(y, dict) else y.numpy())
    dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(results, f)


def run_world(size, tmp, script, args=(), timeout=240):
    """Start ``size`` processes of ``script --worker STORE OUT *args``
    (rank r with ``HOROVOD_RANK=r``, ``HOROVOD_SIZE=size``) on one
    file:// rendezvous under ``tmp``; return each rank's pickled
    results."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "MASTER_", "OMPI_"))}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")  # ranks share cores
    store = os.path.join(tmp, f"store{size}")
    outs = [os.path.join(tmp, f"out{size}_{r}.pkl") for r in range(size)]
    procs = [subprocess.Popen(
        [sys.executable, script, "--worker", store, outs[r], *args],
        env=dict(env, HOROVOD_RANK=str(r), HOROVOD_SIZE=str(size)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(size)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} of {size}:\n{logs[r]}"
    results = []
    for path in outs:
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("collectives"))
    return {n: run_world(n, tmp, os.path.abspath(__file__)) for n in SIZES}


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", CASES)
def test_collective_matches_jax(port_results, case, n):
    want = _jax(case, _inputs(case, n), n)
    for r in range(n):
        got = port_results[n][r][case]
        if isinstance(want, str):
            assert got.startswith("TypeError") and want.startswith(
                "TypeError"), (got, want)
            continue
        w = ({k: v[r] for k, v in want.items()} if isinstance(want, dict)
             else want[r])
        if isinstance(w, dict):
            assert sorted(got) == sorted(w)
            for k in w:
                np.testing.assert_allclose(got[k], w[k], rtol=1e-6)
        else:
            assert got.shape == w.shape and got.dtype == w.dtype
            np.testing.assert_allclose(got, w, rtol=1e-6)


def test_scale_is_the_f32_cast_multiply_cast():
    """``_scale`` on bf16/fp16 equals the reference's explicit form,
    ``(x.float() * f).to(x.dtype)``, bit for bit; integers refuse a
    factor and take 1 or None."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096).astype(np.float32))
    for dtype in (torch.bfloat16, torch.float16):
        xd = x.to(dtype)
        for f in (1 / 3, 0.25, 3.0):
            want = (xd.float() * f).to(dtype)
            assert torch.equal(tc._scale(xd, f), want)
            assert torch.equal(tc._scale(xd.clone(), f, inplace=True), want)
    ints = torch.arange(4)
    assert tc._scale(ints, 1.0) is ints and tc._scale(ints, None) is ints
    with pytest.raises(TypeError, match="integer dtype"):
        tc._scale(ints, 0.5)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2], sys.argv[3])
