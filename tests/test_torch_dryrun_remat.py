"""The op counter (``repro_torch/launch/op_analysis.py``) on rematerialized
train steps (``models/remat.py``), on the CPU, at llama3.2-1b's smoke
config cut to 4 layers and phi3.5-moe's smoke config, B = 4, S = 256:

* the count on the meta device equals the count of the same step on real
  CPU tensors (FLOPs, bytes, the kernels' bookings, peak live bytes), with
  and without remat: the dry run describes the code that runs;
* FLOPs("nothing") - FLOPs(no remat) is one forward of the checkpointed
  bodies, less each dense layer's closing product (the FFN's down
  projection: its autograd node saves its inputs before it runs, so the
  recompute stops there, as JAX's partial evaluation leaves it out; a MoE
  layer saves tensors after its last product, in the aux loss, so all of
  its products run again);
* FLOPs("dots") - FLOPs(no remat) is the bodies' batched products
  (``bmm``: the MoE's experts and its combine) and K11's bookings: the
  no-batch products are kept, not run again;
* the counted peak falls with remat, and further with ``"nothing"``;
* ``python -m repro_torch.launch.dryrun --no-remat`` counts the steps with
  ``remat=False``, and without the flag with each config's own remat.
"""
import pytest
import torch

from repro_torch.data.synthetic import lm_batches
from repro_torch.launch.op_analysis import Counter
from repro_torch.models import layers, registry
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train import steps

B, S = 4, 256
ARCHS = {"llama3.2-1b": {"n_layers": 4}, "phi3.5-moe-42b-a6.6b": {}}
REMATS = {"off": {"remat": False},
          "dots": {"remat": True, "remat_policy": "dots"},
          "nothing": {"remat": True, "remat_policy": "nothing"}}


def _config(arch, remat):
    return registry.get_config(arch, smoke=True).replace(
        **ARCHS[arch], **REMATS[remat])


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _inputs(cfg, device):
    params = registry.init_params(cfg, 0, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             next(lm_batches(cfg.vocab_size, B, S, 1, seed=3)).items()}
    return _to(params, device), _to(batch, device)


def _count_step(arch, remat, device="cpu"):
    cfg = _config(arch, remat)
    params, batch = _inputs(cfg, device)
    opt = make_optimizer("adam")
    state = opt.init(params)
    step = steps.make_train_step(cfg, opt)
    with Counter() as c:
        step(params, state, 0, batch)
    return c


@pytest.fixture(scope="module")
def cpu_counts():
    return {(arch, remat): _count_step(arch, remat)
            for arch in ARCHS for remat in REMATS}


@pytest.mark.parametrize("remat", REMATS)
def test_meta_remat_step_counts_equal_real_cpu(remat, cpu_counts):
    meta = _count_step("llama3.2-1b", remat, "meta")
    real = cpu_counts[("llama3.2-1b", remat)]
    assert meta.totals() == real.totals()
    assert dict(meta.kernels) == dict(real.kernels)
    assert meta.peak_bytes == real.peak_bytes > 0
    n_layers = _config("llama3.2-1b", remat).n_layers
    assert real.kernels["flash_attention"][0] == (
        n_layers if remat == "off" else 2 * n_layers)
    assert real.kernels["flash_attention_bwd_dq"][0] == n_layers
    assert real.kernels["flash_attention_bwd_dkdv"][0] == n_layers


def _forward_bodies(arch):
    """FLOPs of one forward of the checkpointed bodies (the whole forward
    less the unembedding, the only product outside them), and its batched
    products' and K11's shares."""
    cfg = _config(arch, "off")
    params, batch = _inputs(cfg, "cpu")
    with torch.no_grad(), Counter() as fwd:
        registry.forward(cfg, params, batch)
    with torch.no_grad(), Counter() as unembed:
        layers.logits(cfg, params["embed"], torch.zeros(B, S, cfg.d_model))
    bmm = fwd.ops["aten.bmm.default"][1] if "aten.bmm.default" in fwd.ops \
        else 0
    return cfg, fwd.flops - unembed.flops, bmm, fwd.kernels[
        "flash_attention"][1]


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_flops_are_the_recompute(arch, cpu_counts):
    cfg, bodies, batched, k11 = _forward_bodies(arch)
    off = cpu_counts[(arch, "off")].flops
    closing = 0 if cfg.is_moe else (cfg.n_layers * 2 * B * S * cfg.d_ff
                                    * cfg.d_model)
    assert cpu_counts[(arch, "nothing")].flops - off == bodies - closing
    assert cpu_counts[(arch, "dots")].flops - off == batched + k11
    assert k11 > 0 and (batched > 0) == cfg.is_moe


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_lowers_the_counted_peak(arch, cpu_counts):
    off, dots, nothing = (cpu_counts[(arch, r)].peak_bytes for r in REMATS)
    assert nothing < dots < off


@pytest.mark.parametrize("no_remat", [False, True])
def test_dryrun_cli_no_remat_overrides_the_config(no_remat, monkeypatch,
                                                  capsys):
    from repro_torch.launch import dryrun, dryrun_lib

    calls = []

    def run_one(arch, shape, **kw):
        calls.append((arch, shape, kw))
        return {"arch": arch, "shape": shape, "status": "skipped",
                "reason": "not counted here"}

    monkeypatch.setattr(dryrun_lib, "run_one", run_one)
    argv = ["--arch", "llama3.2-1b", "--shape", "train_4k", "--out", "x"]
    assert dryrun.main(argv + ["--no-remat"] * no_remat) == 0
    (arch, shape, kw), = calls
    assert (arch, shape, kw["out_dir"]) == ("llama3.2-1b", "train_4k", "x")
    assert kw["overrides"] == ({"remat": False} if no_remat else None)
    assert "train_4k" in capsys.readouterr().out
