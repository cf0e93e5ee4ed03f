"""Rules the port keeps (checked on the CPU).

* ``src/repro_torch``, ``chip_smoke.py`` and ``ingest_pacing.py`` import
  neither ``jax`` nor the JAX package ``repro`` (nor ``ml_dtypes``, which
  the card's machine lacks);
* the port's ``FFMConfig``, ``ModelConfig`` and ``InputShape`` (with its
  four shapes) equal ``repro.common.config``'s field for field;
* the card is the default: an entry point without ``device`` raises when
  CUDA is absent;
* every kernel wrapper sends CPU tensors to its plain version and counts no
  launch (K13 and K12 through the backward's one wrapper);
* the host pre-gather and the serving roofline keep the card default;
* the training launcher, like the other entry points, trains on the card
  unless told otherwise.
"""
import ast
import dataclasses
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.common.config import INPUT_SHAPES as J_INPUT_SHAPES
from repro.common.config import FFMConfig as JFFMConfig
from repro.common.config import InputShape as JInputShape
from repro.common.config import ModelConfig as JModelConfig
from repro.configs import llama32_1b as j_llama
from repro_torch.checkpoint import transfer as T
from repro_torch.common.config import (INPUT_SHAPES, FFMConfig, InputShape,
                                       ModelConfig)
from repro_torch.configs import llama32_1b
from repro_torch.common.device import resolve_device
from repro_torch.core import deepffm
from repro_torch.kernels import _build
from repro_torch.kernels.ffm_interaction import ops as fi_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.ffm_interaction import ref as fi_ref
from repro_torch.kernels.quantize import ops as q_ops
from repro_torch.kernels.quantize import ref as q_ref
from repro_torch.kernels.row_gather import ops as rg_ops
from repro_torch.kernels.row_gather import ref as rg_ref
from repro_torch.kernels.sparse_mlp import ops as sk_ops
from repro_torch.kernels.sparse_mlp import ref as sk_ref
from repro_torch.launch import train as train_cli
from repro_torch.models import registry
from repro_torch.serving.engine import InferenceEngine
from repro_torch import quickstart
from repro_torch.serving.context_cache import CachedServer
from repro_torch.serving.server import FFMServer, LLMServer
from repro_torch.serving.shard_router import ShardRouter
from repro_torch.train.hogwild import HogwildTrainer
from repro_torch.train.loop import OnlineTrainer
from repro_torch.train.pipeline import TrainingPipeline

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "ingest_pacing.py", ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_imports_neither_jax_nor_repro(path):
    bad = {m for m in _imported_roots(path)
           if m in ("jax", "jaxlib", "repro", "ml_dtypes")}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_file_list_is_complete():
    names = {p.relative_to(ROOT / "src").as_posix() for p in PORT_FILES[:-2]}
    for mod in ("repro_torch/common/config.py", "repro_torch/common/device.py",
                "repro_torch/common/pspec.py", "repro_torch/convert.py",
                "repro_torch/core/quantization.py", "repro_torch/core/ffm.py",
                "repro_torch/core/deepffm.py", "repro_torch/kernels/_build.py",
                "repro_torch/kernels/row_gather/ops.py",
                "repro_torch/kernels/ffm_interaction/ops.py",
                "repro_torch/kernels/ffm_interaction/ref.py",
                "repro_torch/kernels/row_gather/ref.py",
                "repro_torch/serving/prefix_cache.py",
                "repro_torch/serving/engine.py",
                "repro_torch/core/patcher.py",
                "repro_torch/checkpoint/layout.py",
                "repro_torch/checkpoint/transfer.py",
                "repro_torch/kernels/quantize/ops.py",
                "repro_torch/kernels/quantize/ref.py",
                "repro_torch/serving/update_pipe.py",
                "repro_torch/optim/optimizers.py",
                "repro_torch/core/sparse_updates.py",
                "repro_torch/kernels/sparse_mlp/ops.py",
                "repro_torch/kernels/sparse_mlp/ref.py",
                "repro_torch/common/metrics.py",
                "repro_torch/data/synthetic.py",
                "repro_torch/data/prefetch.py",
                "repro_torch/checkpoint/store.py",
                "repro_torch/train/pipeline.py",
                "repro_torch/train/loop.py",
                "repro_torch/configs/llama32_1b.py",
                "repro_torch/configs/phi35_moe.py",
                "repro_torch/configs/granite_8b.py",
                "repro_torch/configs/yi_6b.py",
                "repro_torch/configs/qwen25_3b.py",
                "repro_torch/configs/chameleon_34b.py",
                "repro_torch/configs/mamba2_130m.py",
                "repro_torch/configs/zamba2_7b.py",
                "repro_torch/configs/deepseek_v2_236b.py",
                "repro_torch/models/ssm.py",
                "repro_torch/models/hybrid.py",
                "repro_torch/models/moe.py",
                "repro_torch/models/layers.py",
                "repro_torch/models/attention.py",
                "repro_torch/models/transformer.py",
                "repro_torch/models/registry.py",
                "repro_torch/kernels/flash_attention/ops.py",
                "repro_torch/kernels/flash_attention/ref.py",
                "repro_torch/train/steps.py",
                "repro_torch/serving/server.py",
                "repro_torch/launch/serve.py",
                "repro_torch/launch/train.py",
                "repro_torch/serving/context_cache.py",
                "repro_torch/train/hogwild.py",
                "repro_torch/quickstart.py",
                "repro_torch/analysis/lock_order.py",
                "repro_torch/analysis/lock_witness.py",
                "repro_torch/launch/topology.py",
                "repro_torch/serving/faults.py",
                "repro_torch/serving/shard_router.py",
                "repro_torch/launch/mesh.py",
                "repro_torch/launch/sharding.py",
                "repro_torch/common/runtime.py",
                "repro_torch/launch/specs.py",
                "repro_torch/launch/op_analysis.py",
                "repro_torch/launch/roofline.py",
                "repro_torch/launch/dryrun.py",
                "repro_torch/launch/dryrun_lib.py",
                "repro_torch/launch/dryrun_ffm.py"):
        assert mod in names
    sources = {p.name for p in (ROOT / "src" / "repro_torch" / "csrc").glob("*.cu")}
    assert sources == {"row_gather.cu", "ffm_interaction.cu",
                       "ffm_fused_logits.cu", "quantize.cu", "sparse_mlp.cu",
                       "flash_attention.cu", "flash_attention_bwd.cu"}


@pytest.mark.parametrize("kw", [{}, {"n_fields": 8, "context_fields": 5,
                                     "hash_space": 2**10, "k": 4,
                                     "mlp_hidden": (16, 8)}])
def test_ffm_config_matches_reference(kw):
    ours, theirs = dataclasses.fields(FFMConfig), dataclasses.fields(JFFMConfig)
    assert [(f.name, f.type, f.default) for f in ours] == \
        [(f.name, f.type, f.default) for f in theirs]
    assert dataclasses.asdict(FFMConfig(**kw)) == \
        dataclasses.asdict(JFFMConfig(**kw))
    assert FFMConfig(**kw).n_pairs == JFFMConfig(**kw).n_pairs


@pytest.mark.parametrize("name", ["train_4k", "prefill_32k", "decode_32k",
                                  "long_500k"])
def test_input_shape_matches_reference(name):
    ours = dataclasses.fields(InputShape)
    theirs = dataclasses.fields(JInputShape)
    assert [(f.name, f.type, f.default) for f in ours] == \
        [(f.name, f.type, f.default) for f in theirs]
    assert dataclasses.asdict(INPUT_SHAPES[name]) == \
        dataclasses.asdict(J_INPUT_SHAPES[name])


CONFIG_PAIRS = [(llama32_1b.config, j_llama.config),
                (llama32_1b.smoke, j_llama.smoke),
                (lambda: ModelConfig(n_heads=8, head_dim=16),
                 lambda: JModelConfig(n_heads=8, head_dim=16))]
CONFIG_IDS = ["config", "smoke", "custom"]
for _name in ("phi35_moe", "granite_8b", "yi_6b", "qwen25_3b",
              "chameleon_34b", "deepseek_v2_236b"):
    _ours = importlib.import_module(f"repro_torch.configs.{_name}")
    _theirs = importlib.import_module(f"repro.configs.{_name}")
    for _kind in ("config", "smoke"):
        CONFIG_PAIRS.append((getattr(_ours, _kind), getattr(_theirs, _kind)))
        CONFIG_IDS.append(f"{_name}-{_kind}")


@pytest.mark.parametrize("make,make_ref", CONFIG_PAIRS, ids=CONFIG_IDS)
def test_model_config_matches_reference(make, make_ref):
    ours = dataclasses.fields(ModelConfig)
    theirs = dataclasses.fields(JModelConfig)
    assert [(f.name, f.type, f.default) for f in ours] == \
        [(f.name, f.type, f.default) for f in theirs]
    cfg = make()
    ref = JModelConfig(**dataclasses.asdict(cfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    for prop in ("resolved_head_dim", "q_per_kv", "padded_vocab", "is_moe"):
        assert getattr(cfg, prop) == getattr(ref, prop), prop
    assert cfg == ModelConfig(**dataclasses.asdict(make_ref()))


def test_card_is_the_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    cfg = FFMConfig(n_fields=8, context_fields=5, hash_space=2**10, k=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        deepffm.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    # the update path: the sender quantizes and the receiver decodes on the
    # card unless told otherwise
    params = {"w": torch.zeros(3)}
    with pytest.raises(RuntimeError, match="CUDA"):
        T.Sender().make_update(params)
    snd = T.Sender(device="cpu")
    rcv = T.Receiver()
    rcv.apply_update(snd.make_update(params))
    with pytest.raises(RuntimeError, match="CUDA"):
        rcv.materialize(manifest=snd.manifest)
    # the serving surfaces and the training backends
    with pytest.raises(RuntimeError, match="CUDA"):
        FFMServer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        CachedServer(cfg, deepffm.init_params(cfg, 0, "deepffm", "cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        HogwildTrainer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main()
    for backend in ("hogwild", "local_sgd"):
        with pytest.raises(RuntimeError, match="CUDA"):
            TrainingPipeline(cfg, backend=backend)
    # the fleet: the router's shards, the fan-out trainer and its sender
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardRouter(cfg, n_shards=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainingPipeline(cfg, shard_ranges=[(0, 512), (512, 1024)])
    with pytest.raises(RuntimeError, match="CUDA"):
        T.ShardedSender(ranges=[(0, 3)]).make_updates(params)
    # the LLM side: weights and the server go to the card unless told
    llm = llama32_1b.smoke()
    with pytest.raises(RuntimeError, match="CUDA"):
        registry.init_params(llm, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        registry.init_decode_state(llm, 1, 4)
    cpu_params = registry.init_params(llm, 0, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMServer(llm, cpu_params)
    assert LLMServer(llm, cpu_params, device="cpu").generate(
        torch.zeros((1, 3), dtype=torch.int32), 2).shape == (1, 2)
    # the training launcher trains on the card unless told otherwise
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--arch", "llama3.2-1b", "--smoke", "--steps", "1"])


def _cases():
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    codes = t(rng.integers(-127, 128, (40, 6, 4)).astype(np.int8))
    scale = t(rng.uniform(1e-3, 1e-2, 40).astype(np.float32))
    zero = t(rng.normal(0, 0.05, 40).astype(np.float32))
    idx = t(rng.integers(0, 40, (3, 5)).astype(np.int32))
    ectx = t(rng.normal(size=(2, 4, 2, 4)).astype(np.float32))
    vctx = t(rng.normal(size=(2, 4)).astype(np.float32))
    vcand = t(rng.normal(size=(2, 3, 2)).astype(np.float32))
    ecx = t(rng.normal(size=(2, 3, 2, 4, 4)).astype(np.float32))
    ecc = t(rng.normal(size=(2, 3, 2, 2, 4)).astype(np.float32))
    qcx = t(rng.integers(-127, 128, (2, 3, 2, 4, 4)).astype(np.int8))
    qcc = t(rng.integers(-127, 128, (2, 3, 2, 2, 4)).astype(np.int8))
    grid = (t(rng.uniform(1e-3, 1e-2, (2, 3, 2)).astype(np.float32)),
            t(rng.normal(0, 0.05, (2, 3, 2)).astype(np.float32)))
    e = t(rng.normal(size=(3, 5, 5, 4)).astype(np.float32))
    v = t(rng.normal(size=(3, 5)).astype(np.float32))
    # fused: R=2, Fc=4, Fcand=2, K=4, N=3 (ectx over all F=6 fields)
    ectx_full = t(rng.normal(size=(2, 4, 6, 4)).astype(np.float32))
    depth = t(np.array([0, 3], np.int32))
    base = t(rng.normal(size=(2, 3)).astype(np.float32))
    # wire quantization: a flat weight space and its uint16 codes
    w = t(rng.normal(0, 0.3, 1001).astype(np.float32))
    q = t(rng.integers(0, 2**16, 1001).astype(np.uint16).view(np.int16))
    # the block-skip weight gradient: x (B, I) and a half-masked g (B, J)
    x = t(rng.normal(size=(37, 19)).astype(np.float32))
    gm = t((rng.normal(size=(37, 11)) * (rng.random((37, 11)) < 0.5)
            ).astype(np.float32))
    # attention: q (B, S, H, D), k / v (B, S, Kv, D), GQA 2:1
    fq = t(rng.normal(size=(2, 9, 4, 16)).astype(np.float32))
    fk = t(rng.normal(size=(2, 9, 2, 16)).astype(np.float32))
    fv = t(rng.normal(size=(2, 9, 2, 16)).astype(np.float32))
    # the backward's: K11's output and log-sum-exp, a cotangent
    bwd_args = (fq, fk, fv, *fa_ref.flash_attention_ref(fq, fk, fv,
                                                        return_lse=True),
                t(rng.normal(size=(2, 9, 4, 16)).astype(np.float32)))
    return {
        "gather_dequant_rows_q8": (rg_ops.gather_dequant_rows_q8,
                                   rg_ref.gather_dequant_rows_q8_ref,
                                   (codes, scale, zero, idx)),
        "ffm_candidate_matrices": (fi_ops.ffm_candidate_matrices,
                                   fi_ref.ffm_candidate_matrices_ref,
                                   (ectx, vctx, ecx, ecc, vcand)),
        "ffm_candidate_matrices_q8": (fi_ops.ffm_candidate_matrices_q8,
                                      fi_ref.ffm_candidate_matrices_q8_ref,
                                      (ectx, vctx, qcx, qcc, *grid, vcand)),
        "ffm_interaction_matrix": (fi_ops.ffm_interaction_matrix,
                                   fi_ref.ffm_interaction_matrix_ref, (e, v)),
        "ffm_fused_logits_q8": (fi_ops.ffm_fused_logits_q8,
                                fi_ref.ffm_fused_logits_q8_ref,
                                (ectx_full, vctx, depth, base, qcx, qcc,
                                 *grid, vcand)),
        "ffm_fused_logits_rows": (fi_ops.ffm_fused_logits_rows,
                                  fi_ref.ffm_fused_logits_rows_ref,
                                  (ectx_full, vctx, depth, base, ecx, ecc,
                                   vcand)),
        "minmax": (q_ops.minmax, q_ref.minmax_ref, (w,)),
        "quantize_codes": (q_ops.quantize_codes, q_ref.quantize_codes_ref,
                           (w, -1.21, 2.4 / 65535)),
        "dequantize_codes": (q_ops.dequantize_codes,
                             q_ref.dequantize_codes_ref,
                             (q, -1.21, 2.4 / 65535)),
        "sparse_weight_grad": (sk_ops.sparse_weight_grad,
                               sk_ref.sparse_weight_grad_ref, (x, gm)),
        "flash_attention": (fa_ops.flash_attention, fa_ref.flash_attention_ref,
                            (fq, fk, fv)),
        # K13 and K12 sit behind one wrapper, the backward
        "flash_attention_bwd_dq": (fa_ops.flash_attention_bwd,
                                   fa_ref.flash_attention_bwd_ref, bwd_args),
        "flash_attention_bwd_dkdv": (fa_ops.flash_attention_bwd,
                                     fa_ref.flash_attention_bwd_ref, bwd_args),
    }


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_cpu_tensors_take_the_plain_version(name, monkeypatch):
    """On CPU tensors a wrapper returns its plain version's result, never
    builds the library and counts no launch."""
    def no_build():
        raise AssertionError("the CUDA library was asked for on CPU tensors")

    monkeypatch.setattr(_build, "load", no_build)
    wrapper, plain, args = _cases()[name]
    before = dict(_build.launches)
    got, want = wrapper(*args), plain(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
    assert _build.launches == before


def test_host_gather_and_serving_roofline_hold_the_card_default():
    """The host pre-gather and the serving roofline:
    an engine asking for the host gather still goes to the card unless told
    otherwise; the auto policy never picks the host gather for the card;
    the device bandwidth is measured only on a card."""
    from repro_torch.launch import roofline

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    cfg = FFMConfig(n_fields=8, context_fields=5, hash_space=2**10, k=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(cfg, host_gather=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(cfg, "ffm", quantized=True, fused=True)
    for n in (2**10, 2**18, 2**24):
        assert not rg_ops.use_host_gather(n, torch.device("cuda"))
    with pytest.raises(ValueError, match="CUDA"):
        roofline.measure_device_bandwidth("cpu")
    eng = InferenceEngine(cfg, device="cpu", host_gather=True)
    assert eng.host_gather and not eng.fused


def test_trainer_defaults_to_the_card(tmp_path):
    """The training entry points, like the serving ones, resolve
    ``device=None`` to the card and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    from repro_torch.checkpoint import store

    cfg = FFMConfig(n_fields=8, context_fields=4, hash_space=2**10, k=4,
                    mlp_hidden=(16, 8))
    for make in (lambda: TrainingPipeline(cfg),
                 lambda: OnlineTrainer(cfg, "ffm")):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    pipe = TrainingPipeline(cfg, device="cpu")
    assert pipe.params["lr"]["w"].device.type == "cpu"
    pipe.checkpoint(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        store.load(str(tmp_path))


def test_build_command_targets_sm90a():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    assert _build.BUILD_DIR.relative_to(ROOT).as_posix() + "/" in \
        (ROOT / ".gitignore").read_text().split()
