"""LLM serving (port of ``repro/serving/server.py:LLMServer``): batched
prefill (one forward fills the KV cache) + greedy decode.

``FFMServer`` waits for ROADMAP.md Queue 1 item 3. The JAX server's
stepwise warm-up, which serves the families without a batched prefill,
raises here until those families are ported (Queue 1 item 6).
"""
from __future__ import annotations

import time

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.convert import to_device
from repro_torch.models import registry, transformer
from repro_torch.serving.engine import ServeStats
from repro_torch.train.steps import make_serve_step


class LLMServer:
    """Batched prefill + greedy decode on one device (the card unless
    ``device="cpu"``). ``last_prefill_s`` / ``last_decode_s`` hold the last
    :meth:`generate`'s split, host clock around work that ends in a
    synchronize on the card."""

    def __init__(self, cfg: ModelConfig, params, *, window: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg, self.window = cfg, window
        self.params = to_device(params, self.device)
        self._serve = make_serve_step(cfg, window=window)
        self.stats = ServeStats()
        self.last_prefill_s = self.last_decode_s = 0.0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def generate(self, prompts, gen_len: int) -> torch.Tensor:
        """prompts: (B, P) token ids -> generated ids (B, gen_len) int32
        (greedy), on the server's device."""
        cfg = self.cfg
        if not (cfg.family == "dense" and cfg.attn_kind == "gqa"
                and cfg.kv_cache_dtype == "native"):
            raise NotImplementedError(
                f"{cfg.arch_id}: the stepwise warm-up for families without a "
                "batched prefill is not ported (ROADMAP.md Queue 1 item 6)")
        prompts = torch.as_tensor(prompts, device=self.device)
        b, p = prompts.shape
        state = registry.init_decode_state(cfg, b, p + gen_len + 1,
                                           window=self.window,
                                           device=self.device)
        t0 = time.perf_counter()
        logits, state = transformer.prefill(cfg, self.params, prompts, state,
                                            window=self.window)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        self._sync()
        t1 = time.perf_counter()
        outs = []
        for _ in range(gen_len):
            outs.append(tok)
            tok, state = self._serve(self.params, state, tok)
        gen = torch.stack(outs, 1) if outs else torch.zeros(
            (b, 0), dtype=torch.int32, device=self.device)
        self._sync()
        t2 = time.perf_counter()
        self.last_prefill_s, self.last_decode_s = t1 - t0, t2 - t1
        self.stats.record(t2 - t0, b * gen_len, requests=b)
        return gen
