"""Model facade: parameter specs and init, ``prefill``, ``decode_step``,
``init_cache`` and ``quantize_params`` for the dense decoder.

Parameters are a dict tree of tensors: ``embed``, ``final_norm``,
``lm_head`` and one list per layer group ``g{gi}`` holding a dict
``{"b0": block params}`` per layer.  ``convert.from_jax_params`` builds
this tree from the reference's stacked one.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.plan import PlanBook
from .layers import (embed_apply, embed_spec, linear_apply, linear_spec,
                     quantize_tt_params, rmsnorm_apply, rmsnorm_spec)
from .spec import init_tree
from .transformer import Group, group_decode, group_fwd, group_spec


class Model:
    """One dense decoder.  ``device=None`` means the GPU; pass
    ``device="cpu"`` for the plain path."""

    def __init__(self, cfg: ModelConfig, groups: list[Group],
                 param_dtype: torch.dtype = torch.float32,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.groups = groups
        self.param_dtype = param_dtype
        self.device = resolve_device(device)
        # full fp32 matmuls on the card: TF32 would change the numbers the
        # port is held to against the reference
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self._plan_book: PlanBook | None = None

    @property
    def plan_book(self) -> PlanBook:
        """Per-model plan registry, primed from the param specs on first
        use, so prefill and decode resolve no plan."""
        if self._plan_book is None:
            book = PlanBook.from_tt_config(self.cfg.tt)
            book.prime(self.param_specs())
            self._plan_book = book
        return self._plan_book

    # ------------------------------------------------------------------ specs
    def param_specs(self) -> dict:
        cfg, dt = self.cfg, self.param_dtype
        specs: dict = {"embed": embed_spec(cfg.vocab_size, cfg.d_model, dt),
                       "final_norm": rmsnorm_spec(cfg.d_model, dt),
                       "lm_head": linear_spec(cfg.d_model, cfg.vocab_size,
                                              cfg.tt, "lm_head", dt)}
        for gi, g in enumerate(self.groups):
            specs[f"g{gi}"] = group_spec(cfg, g, dt)
        return specs

    def init(self, seed: int = 0) -> dict:
        """Random parameters drawn from a ``torch.Generator`` seeded with
        ``seed`` on the model's device."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return init_tree(self.param_specs(), gen, self.device)

    def quantize_params(self, params: dict) -> dict:
        """int8-quantize every TT core bundle (a checkpoint transform); the
        result is served by the same entry points through the int8
        kernel."""
        return quantize_tt_params(params)

    # ---------------------------------------------------------------- serving
    def _logits(self, params, x) -> torch.Tensor:
        x = rmsnorm_apply(params["final_norm"], x, self.cfg.norm_eps)
        return linear_apply(params["lm_head"], x, self.plan_book).float()

    @torch.no_grad()
    def prefill(self, params, batch: dict) -> tuple[torch.Tensor, dict]:
        """Process the prompt ``batch["tokens"] [B,S]``; return
        (last-token logits [B,1,V] fp32, cache).  ``batch["cache_len"]``
        (default S) sizes the cache; ``cache["pos"]`` is a Python int."""
        tokens = batch["tokens"].to(self.device)
        x = embed_apply(params["embed"], tokens)
        B, S, _ = x.shape
        positions = torch.arange(S, device=self.device).expand(B, S)
        T = batch.get("cache_len", S)
        cache: dict = {"pos": S}
        for gi, g in enumerate(self.groups):
            x, cache[f"g{gi}"] = group_fwd(
                params[f"g{gi}"], g, self.cfg, x, positions, want_cache=True,
                T_cache=T, plans=self.plan_book)
        return self._logits(params, x[:, -1:, :]), cache

    @torch.no_grad()
    def decode_step(self, params, cache: dict, token: torch.Tensor
                    ) -> tuple[torch.Tensor, dict]:
        """token [B,1] → (logits [B,1,V] fp32, cache at ``pos + 1``).  The
        KV tensors of ``cache`` are updated in place."""
        pos = cache["pos"]
        x = embed_apply(params["embed"], token.to(self.device))
        new_cache: dict = {"pos": pos + 1}
        for gi, g in enumerate(self.groups):
            x, new_cache[f"g{gi}"] = group_decode(
                params[f"g{gi}"], g, self.cfg, x, cache[f"g{gi}"], pos,
                plans=self.plan_book)
        return self._logits(params, x), new_cache

    def init_cache(self, B: int, T: int, dtype=torch.bfloat16) -> dict:
        """Zeroed decode cache for ``B`` rows and ``T`` positions."""
        cfg = self.cfg
        shape = (B, T, cfg.num_kv_heads, cfg.head_dim)
        cache: dict = {"pos": 0}
        for gi, (period, count) in enumerate(self.groups):
            cache[f"g{gi}"] = [
                {f"b{i}": {n: torch.zeros(shape, dtype=dtype,
                                          device=self.device)
                           for n in ("k", "v")}
                 for i in range(len(period))}
                for _ in range(count)]
        return cache

