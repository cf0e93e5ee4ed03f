"""The port's expert-parallel MoE (``repro_torch/models/moe.py``:
``moe_expert_parallel``, two ``all_to_all`` over the model axis) against the
JAX package's on the CPU.

phi3.5-moe's smoke config (d 128, 4 experts of 256, top-2) with JAX's
``init_params`` weights for one MoE layer, x of (8, 32, 128) from a seed
(with a mean along expert 0's router column, so that expert is
over-subscribed).
JAX runs ``moe_expert_parallel`` under ``shard_map`` on a 2 x 4 mesh of 8
forced host devices (a subprocess), and ``moe_dense``; the port runs on a
2 x 4 gloo world (one spawn for the file), each rank on its rows:

* at the config's capacity factor (1.25: 20 slots per (device, expert) for
  32 tokens a device), where copies are dropped (asserted: the drops are
  counted by the stable-sort rule in numpy), the port's y and aux equal
  JAX's expert-parallel ones;
* at capacity factor 8 (no drops) they equal JAX's ``moe_dense``.

Each in two layouts: "split" (the rank's data rows and its experts'
model-axis slices, as the sharded train step passes them) and "whole" (all
of x and whole expert leaves on every rank, as for a batch that does not
divide). Routing is the same on both sides: every token's k-th router
probability stands more than ``2 TOL`` of the largest above its (k+1)-th.
Tolerance ``TOL`` = 1e-5 of the largest |y| (one f32 layer; the sums run
in other orders in XLA and torch), 1e-6 relative for aux.
``_positions_within_expert`` equals JAX's exactly.
"""
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import pspec as j_pspec
from repro.models import moe as j_moe
from repro.models import registry as j_registry
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import moe
from tests import _torch_mesh_ranks as R
from tests._subproc import run_with_devices

TOL = 1e-5
AUX_RTOL = 1e-6
PHI = "phi3.5-moe-42b-a6.6b"
X_SHAPE = (8, 32, 128)
N_DATA, N_MODEL = 2, 4
CASES = [(f"{layout}-cf{cf}", layout, cf) for layout in ("split", "whole")
         for cf in (1.25, 8.0)]


def _inputs(path):
    """JAX's weights for one MoE layer and a seeded x, to ``path``."""
    jcfg = j_registry.get_config(PHI, smoke=True)
    p = j_pspec.materialize(j_moe.moe_specs(jcfg), jax.random.PRNGKey(0))
    # a mean along expert 0's router column over-subscribes that expert,
    # as skewed traffic does, so copies drop at the config's capacity
    col = np.asarray(p["router"])[:, 0]
    x = (np.random.default_rng(1).normal(size=X_SHAPE)
         + 0.5 * col / np.linalg.norm(col) * np.sqrt(X_SHAPE[-1]) / 4
         ).astype(np.float32)
    np.savez(path, x=x, **{f"p/{k}": np.asarray(v) for k, v in p.items()})
    return jcfg, {k: np.asarray(v) for k, v in p.items()}, x


def _jax_outputs(in_path):
    """JAX's expert-parallel y and aux at each capacity factor on a 2 x 4
    mesh of 8 host devices, and ``moe_dense``'s."""
    out_path = in_path.replace(".npz", "_jax.npz")
    run_with_devices(f"""
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.common.runtime import Runtime
from repro.models import moe
from repro.models.registry import get_config
z = np.load({in_path!r})
x = jnp.asarray(z["x"])
p = {{k[2:]: jnp.asarray(z[k]) for k in z.files if k.startswith("p/")}}
mesh = Mesh(np.asarray(jax.devices()[:8]).reshape({N_DATA}, {N_MODEL}),
            ("data", "model"))
rt = Runtime(mesh=mesh, data_axes=("data",))
out = {{}}
for cf in (1.25, 8.0):
    cfg = get_config("{PHI}", smoke=True).replace(capacity_factor=cf)
    with mesh:
        y, aux = jax.jit(lambda p, x: moe.moe_expert_parallel(cfg, p, x, rt))(
            p, x)
    out[f"ep{{cf}}|y"], out[f"ep{{cf}}|aux"] = np.asarray(y), np.asarray(aux)
y, aux = moe.moe_dense(cfg, p, x)
out["dense|y"], out["dense|aux"] = np.asarray(y), np.asarray(aux)
np.savez({out_path!r}, **out)
""", n_devices=8)
    with np.load(out_path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("moe"))
    in_path = os.path.join(d, "inputs.npz")
    jcfg, p, x = _inputs(in_path)
    with ThreadPoolExecutor(1) as pool:
        jax_out = pool.submit(_jax_outputs, in_path)
        mesh_lib.spawn(R.moe_rank, N_DATA * N_MODEL, in_path, d, CASES)
        want = jax_out.result()
    ranks = []
    for r in range(N_DATA * N_MODEL):
        with np.load(os.path.join(d, f"rank{r}.npz")) as z:
            ranks.append({k: z[k] for k in z.files})
    return jcfg, p, x, want, ranks


def _copies_dropped(jcfg, p, x, cf):
    """Copies past their (device, expert) capacity, counted in numpy from
    JAX's router ids by the stable-sort rule, per device chunk of tokens."""
    _, ids, probs = j_moe._router(jcfg, jnp.asarray(p["router"]),
                                  jnp.asarray(x.reshape(-1, x.shape[-1])))
    ids = np.asarray(ids)
    t_l = ids.shape[0] // (N_DATA * N_MODEL)
    cap = max(int(t_l * jcfg.top_k / jcfg.n_experts * cf), 1)
    cap = min(cap + (-cap) % 4, t_l * jcfg.top_k)
    dropped = 0
    for dev in range(N_DATA * N_MODEL):
        flat = ids[dev * t_l:(dev + 1) * t_l].reshape(-1)
        for e in range(jcfg.n_experts):
            dropped += max(int((flat == e).sum()) - cap, 0)
    return dropped, np.asarray(probs)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_expert_parallel_matches_jax(results, case):
    jcfg, p, x, want, ranks = results
    _, layout, cf = next(c for c in CASES if c[0] == case)
    dropped, probs = _copies_dropped(jcfg, p, x, cf)
    top = np.sort(probs, axis=-1)[:, ::-1]
    gaps = top[:, jcfg.top_k - 1] - top[:, jcfg.top_k]
    assert float(gaps.min()) > 2 * TOL * float(top.max()), gaps.min()
    ref = f"ep{cf}" if cf < 8 else "dense"
    if cf < 8:
        assert dropped > 0, "the case should drop copies"
    else:
        assert dropped == 0
    wy, waux = want[f"{ref}|y"], float(want[f"{ref}|aux"])
    rows = X_SHAPE[0] // N_DATA
    scale = float(np.abs(wy).max())
    for r, got in enumerate(ranks):
        y = got[f"{case}|y"]
        first = int(got[f"{case}|first"])
        part = wy[first:first + rows] if layout == "split" else wy
        assert y.shape == part.shape, (r, y.shape)
        err = float(np.abs(y - part).max())
        assert err <= TOL * scale, (r, err)
        aux = float(got[f"{case}|aux"])
        assert abs(aux - waux) <= AUX_RTOL * abs(waux), (r, aux, waux)
    if cf < 8:  # the drops show: EP differs from the dense combine
        assert float(np.abs(wy - want["dense|y"]).max()) > 100 * TOL * scale


@pytest.mark.parametrize("n,e", [(64, 4), (257, 16), (1, 3)])
def test_positions_within_expert_match_jax(n, e):
    ids = np.random.default_rng(n).integers(0, e, n).astype(np.int32)
    got = moe._positions_within_expert(torch.from_numpy(ids), e)
    want = j_moe._positions_within_expert(jnp.asarray(ids), e)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
