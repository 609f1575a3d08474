"""The port's sequence-parallel attention (``horovod_tpu_torch.parallel.
ring_attention``) against the JAX package's, on gloo worlds of sp = 2
and 4 processes (each run once for the file by a module fixture).

The same global q/k/v ``[B, T, H, D]`` and output cotangent, drawn
from a seed with numpy in f32, are cut into ``sp`` contiguous sequence
chunks; rank ``r`` runs its chunk through ``ring_self_attention``,
``ring_flash_attention`` (causal and not; its chunks through the flash
kernel's plain version) and ``ulysses_attention`` over the world, then
the backward of ``sum(out * cot)``. The JAX side runs the same
functions under ``shard_map`` on an sp mesh of the test platform's
virtual CPU devices (``ring_flash`` through ``make_sp_attention``, the
Pallas kernel in interpret mode) and ``jax.grad`` of the same sum. Each
rank's output and its chunk's q/k/v gradients are held to JAX's chunk
at the JAX tests' own tolerances: forward 2e-5 (ring, Ulysses:
``tests/test_models.py``) and 3e-5 (ring_flash), gradients 2e-3
(ring_flash: ``tests/test_flash_attention.py``) and 2e-5 (ring,
Ulysses: the plain einsums on both sides differ only in f32 summation
order).

The workers run this file as a script (``--worker``) and load torch,
numpy and the port only.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))

from test_torch_collectives import run_world  # noqa: E402

SIZES = (2, 4)
B, T, H, D = 2, 32, 4, 16
# (name, impl, causal)
CASES = [("ring", "ring", True), ("ring-noncausal", "ring", False),
         ("ring_flash", "ring_flash", True),
         ("ring_flash-noncausal", "ring_flash", False),
         ("ulysses", "ulysses", True)]
TOL = {"ring": (2e-5, 2e-5), "ulysses": (2e-5, 2e-5),
       "ring_flash": (3e-5, 2e-3)}


def _inputs():
    rng = np.random.default_rng(0)
    return [rng.standard_normal((B, T, H, D)).astype(np.float32)
            for _ in range(4)]          # q, k, v, cotangent


# ---------------------------------------------------------------------------
# The port (worker side)
# ---------------------------------------------------------------------------

class _SpMesh:
    """Stands in for a ``DeviceMesh`` with dims dp=1, sp=``n``."""
    mesh_dim_names = ("dp", "sp")

    def __init__(self, n):
        self.n = n

    def size(self, dim):
        return (1, self.n)[dim]


def _worker(store, out):
    import torch.distributed as dist

    from horovod_tpu_torch.parallel import ring_attention as tra
    from horovod_tpu_torch.parallel import tensor_parallel as ttp
    from horovod_tpu_torch.parallel.mesh import (build_mesh,
                                                 init_process_group, sp_group)

    init_process_group("cpu", init_method=f"file://{store}", timeout=120)
    n, r = dist.get_world_size(), dist.get_rank()
    mesh = build_mesh(sp=n)
    chunk = T // n
    q, k, v, cot = (torch.from_numpy(a[:, r * chunk:(r + 1) * chunk].copy())
                    for a in _inputs())
    results = {}
    for name, impl, causal in CASES:
        qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
        ttp.reset_counters()
        out_ = tra.sequence_sharded_attention(*qkv, mesh, impl=impl,
                                              causal=causal)
        (out_ * cot).sum().backward()
        results[name] = {"out": out_.detach().numpy(),
                         "grads": [x.grad.numpy() for x in qkv],
                         "counters": {kk: dict(vv) for kk, vv
                                      in ttp.counters.items()}}
    results["group_is_sp"] = sp_group(mesh) is mesh.get_group("sp")
    dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(results, f)


# ---------------------------------------------------------------------------
# The JAX side
# ---------------------------------------------------------------------------

def _jax(impl, causal, n):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from horovod_tpu.common.jax_compat import shard_map
    from horovod_tpu.parallel import ring_attention as jra

    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    spec = P(None, "sp", None, None)
    if impl == "ring_flash":
        full = Mesh(np.array(jax.devices()[:n]).reshape(1, 1, 1, n, 1, 1),
                    ("dp", "fsdp", "pp", "sp", "tp", "ep"))
        att = jra.make_sp_attention(full, impl="ring_flash", causal=causal)
    else:
        body = {"ring": jra.ring_self_attention,
                "ulysses": jra.ulysses_attention}[impl]
        att = shard_map(lambda a, b, c: body(a, b, c, axis_name="sp",
                                             causal=causal),
                        mesh=mesh, in_specs=(spec,) * 3, out_specs=spec)
    q, k, v, cot = (jnp.asarray(a) for a in _inputs())
    out = jax.jit(att)(q, k, v)
    grads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(att(a, b, c) * cot),
                             argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ring_attention"))
    return {n: run_world(n, tmp, os.path.abspath(__file__))
            for n in SIZES}


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name,impl,causal", CASES)
def test_sp_attention_matches_jax(port_results, name, impl, causal, n):
    want_out, want_grads = _jax(impl, causal, n)
    fwd_tol, grad_tol = TOL[impl]
    chunk = T // n
    for r, res in enumerate(port_results[n]):
        got = res[name]
        sl = (slice(None), slice(r * chunk, (r + 1) * chunk))
        np.testing.assert_allclose(got["out"], want_out[sl], rtol=fwd_tol,
                                   atol=fwd_tol)
        for g, w, x in zip(got["grads"], want_grads, "qkv"):
            np.testing.assert_allclose(g, w[sl], rtol=grad_tol,
                                       atol=grad_tol, err_msg=f"d{x}")


@pytest.mark.parametrize("n", SIZES)
def test_ring_and_alltoall_traffic_is_the_formula(port_results, n):
    """The ring sends K/V (stacked) sp - 1 times forward and its
    gradient sp - 1 times back; Ulysses makes one all-to-all of q/k/v
    and one of the output, each way."""
    chunk_bytes = B * (T // n) * H * D * 4
    for res in port_results[n]:
        assert res["group_is_sp"]
        for name in ("ring", "ring_flash", "ring_flash-noncausal"):
            c = res[name]["counters"]
            assert c["sp_p2p"] == {"calls": 2 * (n - 1),
                                   "bytes": 2 * (n - 1) * 2 * chunk_bytes}
            assert c["sp_a2a"]["calls"] == c["tp"]["calls"] == 0
        c = res["ulysses"]["counters"]
        assert c["sp_a2a"] == {"calls": 4, "bytes": 2 * 4 * chunk_bytes}
        assert c["sp_p2p"]["calls"] == 0


def test_flash_and_local_refuse_a_split_sequence():
    """As the reference: ``"flash"`` with sp > 1 raises, naming
    ring_flash; ``"local"`` would attend within a chunk and raises."""
    from horovod_tpu_torch.parallel.ring_attention import make_sp_attention

    with pytest.raises(NotImplementedError, match="ring_flash"):
        make_sp_attention(_SpMesh(2), impl="flash")
    with pytest.raises(NotImplementedError, match="ring"):
        make_sp_attention(_SpMesh(2), impl="local")
    with pytest.raises(ValueError, match="unknown"):
        make_sp_attention(_SpMesh(2), impl="bogus")
    assert make_sp_attention(_SpMesh(1), impl="flash").handles_gqa


def test_attend_and_merge_over_chunks_equals_the_whole_sequence():
    """The one-card form of ``ring_flash_attention``: each rank's
    ``attend_and_merge`` over the chunks in ring order (through the
    kernel's plain version on the CPU) gives the whole-sequence
    ``flash_attention_with_lse``'s out, lse and gradients."""
    from horovod_tpu_torch.ops.flash_attention import \
        flash_attention_with_lse
    from horovod_tpu_torch.parallel import ring_attention as tra

    rng = np.random.default_rng(3)
    sp, bh, t, d = 4, 3, 64, 16
    q, k, v, g = (torch.from_numpy(rng.standard_normal((bh, t, d)).astype(
        np.float32)).requires_grad_(i < 3) for i in range(4))
    gl = torch.from_numpy(rng.standard_normal((bh, t)).astype(np.float32))
    c = t // sp
    outs, lses = [], []
    for r in range(sp):
        carry = tra.ring_carry(q[:, r * c:(r + 1) * c])
        for i in range(sp):
            src = (r + i) % sp
            carry = tra.attend_and_merge(
                q[:, r * c:(r + 1) * c], k[:, src * c:(src + 1) * c],
                v[:, src * c:(src + 1) * c], carry,
                case=tra.chunk_case(src, r, True), scale=d ** -0.5)
        out, lse = tra.merged_result(carry)
        outs.append(out)
        lses.append(lse)
    out, lse = torch.cat(outs, 1), torch.cat(lses, 1)
    got = torch.autograd.grad((out * g).sum() + (lse * gl).sum(), (q, k, v))
    w_out, w_lse = flash_attention_with_lse(q, k, v, causal=True,
                                            out_dtype=torch.float32)
    want = torch.autograd.grad((w_out * g).sum() + (w_lse * gl).sum(),
                               (q, k, v))
    torch.testing.assert_close(out, w_out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, w_lse, rtol=1e-5, atol=1e-5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2], sys.argv[3])
