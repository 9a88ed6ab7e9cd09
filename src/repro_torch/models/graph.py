"""The fixed-batch decode step captured as a CUDA graph: the port's
analogue of the reference's ``Model.jitted_decode_step``.

A :class:`DecodeGraph` belongs to one model and one (batch, cache length).
It owns static buffers: the token [B,1], a KV cache with its position, and
the logits [B,1,V] the captured step writes.  The graph holds one
``Model.decode_step`` on those buffers followed by the position's advance,
so a replay is one launch from the host, and the position moves on the
device.  The step is the eager one, op for op, so a replay gives the eager
step's logits bit for bit.

Capture happens at the first ``load``: the step first runs once eagerly on
a side stream at the same batch and cache length (this builds the kernel
library, fills the launch-geometry memos and the chain's address tables,
and opts each kernel into its shared memory), then it is captured.  A
capture or a replay that fails raises; nothing falls back to the eager
step.

Kernel wrappers do not run on replay: the TT launches a capture recorded
(``tt_contract.CAPTURE_COUNTS``) are kept per graph and added to the
model's ``replayed_launches`` at every replay.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from repro_torch.kernels import tt_contract
from .spec import map_tree

if TYPE_CHECKING:
    from .model import Model

# eager steps on the side stream before the capture
WARMUP_STEPS = 1


def _leaves(tree) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    map_tree(out.append, tree)
    return out


class DecodeGraph:
    """The decode step of ``model`` for ``B`` rows over a cache of ``T``
    positions, captured once and replayed at every position.

    ``load(params, cache, pos)`` copies a prefill's cache into the static
    buffers (capturing first, or again when ``params`` is another tree);
    each call ``graph(token)`` then decodes one token and returns the static
    logits [B,1,V], which the next replay overwrites.  A host mirror of the
    position refuses a replay outside the cache before it runs.
    """

    def __init__(self, model: "Model", B: int, T: int):
        if model.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA model, not "
                             f"{model.device}: decode eagerly on the CPU")
        self.model, self.B, self.T = model, B, T
        self.graph: torch.cuda.CUDAGraph | None = None
        # the captured step reads these parameters' memory at every replay,
        # so the graph keeps them alive
        self.params = None
        self.cache: dict | None = None
        self.token = torch.zeros((B, 1), dtype=torch.int64,
                                 device=model.device)
        self.logits: torch.Tensor | None = None
        self.pos = 0                      # host mirror of cache["pos"]
        # TT launches one replay makes, by kernel name
        self.captured: dict[str, int] = {}

    def _step(self) -> torch.Tensor:
        logits, new = self.model.decode_step(self.params, self.cache,
                                             self.token)
        self.cache["pos"].copy_(new["pos"])
        return logits

    def _capture(self, params, like: dict) -> None:
        dev = self.model.device
        self.graph = self.logits = None
        self.params = params
        self.cache = map_tree(torch.zeros_like, like)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
        before = tt_contract.capture_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                logits = self._step()
        except Exception as e:
            self.params = self.cache = None
            raise RuntimeError(
                f"capturing the decode step of {self.B} rows over a cache "
                f"of {self.T} failed") from e
        self.captured = {k: v - before.get(k, 0)
                         for k, v in tt_contract.capture_counts().items()
                         if v != before.get(k, 0)}
        self.graph, self.logits = graph, logits
        self.model.graph_captures += 1

    def load(self, params, cache: dict, pos: int) -> None:
        """Copy ``cache`` (a prefill's, at the scalar position whose host
        value is ``pos``) into the static buffers, capturing first when
        there is no graph for ``params`` yet."""
        if cache["pos"].dim() != 0:
            raise ValueError("the fixed-batch graph decodes at one position "
                             "shared by the batch")
        src = _leaves(cache)
        if any(t.shape[:2] != (self.B, self.T) for t in src if t.dim()) or (
                self.cache is not None and
                [(t.shape, t.dtype) for t in _leaves(self.cache)] !=
                [(t.shape, t.dtype) for t in src]):
            raise ValueError(f"the cache does not have the graph's shapes: "
                             f"{self.B} rows over {self.T} positions")
        if self.graph is None or params is not self.params:
            self._capture(params, cache)
        for d, s in zip(_leaves(self.cache), src):
            d.copy_(s)
        self.pos = pos

    def __call__(self, token: torch.Tensor) -> torch.Tensor:
        """Decode ``token [B,1]`` at the loaded position; returns the
        static logits [B,1,V]."""
        if self.graph is None:
            raise RuntimeError("load a cache before replaying the graph")
        if not 0 <= self.pos < self.T:
            raise ValueError(f"decode position {self.pos} outside the cache "
                             f"of {self.T}")
        self.token.copy_(token)
        self.graph.replay()
        self.pos += 1
        self.model.replayed_launches.update(self.captured)
        return self.logits

