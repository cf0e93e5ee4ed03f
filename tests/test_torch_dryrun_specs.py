"""The dry run's inputs and shardings against the JAX package's, on the
CPU, with no world and no memory (meta tensors against JAX's
``ShapeDtypeStruct``s; the rules read an ``abstract_mesh``).

* ``INPUT_SHAPES``: the same four shapes in the same order.
* ``specs.batch_specs`` / ``decode_specs``: every leaf's shape and dtype
  equal JAX's (``jax.eval_shape`` of its ``init_decode_state``) for every
  arch id x input shape (``pos``: a Python int 0 here, a 0-d int32 there);
  ``effective_window`` and ``shape_supported`` equal JAX's.
* ``sharding.zero1_shardings`` and ``decode_state_shardings``: every
  leaf's spec equals JAX's on an ``AbstractMesh`` of (16, 16) and (2, 16,
  16), for every arch id (and the int8 cache's scales on qwen2.5-3b).
"""
import jax
import pytest
import torch

from repro.common.config import INPUT_SHAPES as J_INPUT_SHAPES
from repro.launch import sharding as j_sharding
from repro.launch import specs as j_specs
from repro.models import registry as j_registry
from repro_torch.common.config import INPUT_SHAPES
from repro_torch.launch import sharding, specs
from repro_torch.models import registry
from tests import _torch_mesh_ranks as R

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _jax_flat(tree, fn):
    return {"/".join(str(getattr(k, "key", k)) for k in path): fn(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _port_flat(tree):
    return {k: ((tuple(v.shape), _dtype_name(v.dtype))
                if isinstance(v, torch.Tensor) else v)
            for k, v in R.flatten(tree).items()}


def test_input_shapes_in_order():
    assert list(INPUT_SHAPES) == list(J_INPUT_SHAPES)
    for name, shape in INPUT_SHAPES.items():
        assert (shape.name, shape.seq_len, shape.global_batch, shape.kind) == \
            tuple(getattr(J_INPUT_SHAPES[name], f)
                  for f in ("name", "seq_len", "global_batch", "kind"))


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_specs_match_jax(arch, shape):
    cfg, jcfg = registry.get_config(arch), j_registry.get_config(arch)
    s, js = INPUT_SHAPES[shape], J_INPUT_SHAPES[shape]
    assert specs.effective_window(cfg, s) == j_specs.effective_window(
        jcfg, js)
    assert specs.shape_supported(cfg, s) == j_specs.shape_supported(jcfg, js)
    sds = lambda a: (tuple(a.shape), str(a.dtype))  # noqa: E731
    if s.kind != "decode":
        got = _port_flat(specs.batch_specs(cfg, s))
        assert got == _jax_flat(j_specs.batch_specs(jcfg, js), sds)
        assert all(v.device.type == "meta" for v in
                   specs.batch_specs(cfg, s).values())
        return
    if not specs.shape_supported(cfg, s)[0]:
        return
    w = specs.effective_window(cfg, s)
    state, tokens = specs.decode_specs(cfg, s, window=w)
    j_state, j_tokens = j_specs.decode_specs(jcfg, js, window=w)
    got, want = _port_flat(state), _jax_flat(j_state, sds)
    assert got.pop("pos") == 0 and want.pop("pos") == ((), "int32")
    assert got == want
    assert sds(tokens)[0] == sds(j_tokens)[0]
    assert _dtype_name(tokens.dtype) == str(j_tokens.dtype)
    assert all(t.device.type == "meta" for t in R.flatten(state).values()
               if isinstance(t, torch.Tensor))


def _jax_param_shardings(jcfg, amesh):
    return j_sharding.param_shardings(
        jcfg, j_registry.param_axes(jcfg), j_registry.abstract_params(jcfg),
        amesh)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_zero1_shardings_match_jax(arch, mesh):
    sizes, names = MESHES[mesh]
    amesh = j_sharding.abstract_mesh(sizes, names)
    cfg, jcfg = registry.get_config(arch), j_registry.get_config(arch)
    want = _jax_flat(j_sharding.zero1_shardings(
        _jax_param_shardings(jcfg, amesh), j_registry.abstract_params(jcfg),
        amesh), lambda s: tuple(s.spec))
    mesh_sizes = sharding.abstract_mesh(sizes, names)
    assert mesh_sizes == dict(zip(names, sizes))
    p_specs = sharding.param_shardings(cfg, registry.param_axes(cfg),
                                       registry.param_specs(cfg), mesh_sizes)
    got = R.flatten(sharding.zero1_shardings(
        p_specs, registry.abstract_params(cfg), mesh_sizes))
    assert sorted(got) == sorted(want)
    for path, spec in got.items():
        assert spec == want[path], (path, spec, want[path])
    data = tuple(n for n in names if n != "model")
    entry = data if len(data) > 1 else data[0]
    assert any(entry in s for s in got.values())  # ZeRO-1 slices some leaf


# seamless at long_500k is left out, as JAX's dry run skips it
DECODE_CASES = [(a, s) for a in registry.ARCH_IDS
                for s in ("decode_32k", "long_500k")
                if (a, s) != ("seamless-m4t-large-v2", "long_500k")] + [
    ("qwen2.5-3b+int8", "decode_32k")]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "-".join(c))
def test_decode_state_shardings_match_jax(case, mesh):
    arch, shape = case
    name, _, kind = arch.partition("+")
    cfg, jcfg = registry.get_config(name), j_registry.get_config(name)
    if kind:
        cfg = cfg.replace(kv_cache_dtype="int8")
        jcfg = jcfg.replace(kv_cache_dtype="int8")
    s, js = INPUT_SHAPES[shape], J_INPUT_SHAPES[shape]
    sizes, names = MESHES[mesh]
    amesh = j_sharding.abstract_mesh(sizes, names)
    w = specs.effective_window(cfg, s)
    state, _ = specs.decode_specs(cfg, s, window=w)
    j_state, _ = j_specs.decode_specs(jcfg, js, window=w)
    want = _jax_flat(j_sharding.decode_state_shardings(jcfg, j_state, amesh),
                     lambda sh: tuple(sh.spec))
    got = R.flatten(sharding.decode_state_shardings(
        cfg, state, sharding.abstract_mesh(sizes, names)))
    assert sorted(got) == sorted(want)
    for path, spec in got.items():
        assert spec == want[path], (path, spec, want[path])
    if kind:
        assert "cache/k_scale" in got
