"""Batch pipeline with exact skip-ahead resume.

The iterator is stateless but for the step counter: ``batch_at(step)`` is
a pure function of the step, so a resume after a restart replays the
exact token stream. Batches are made on the pipeline's ``device``
(default: the card). Counterpart of ``repro.data.pipeline``; the JAX
package's multi-host assembly of a global batch waits for the multi-card
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import torch

from ..kernels.backend import resolve_device
from .synthetic import lm_batch, step_generator

__all__ = ["DataConfig", "DataPipeline"]

_EMBED_STREAM = 2**31 - 1      # the shard index of the embeddings' stream


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int
    global_batch: int
    seq_len: int
    vocab: int
    input_kind: str = "tokens"        # tokens | embeds | encdec
    d_model: int = 0                  # for stub-frontend archs


class DataPipeline:
    def __init__(self, cfg: DataConfig, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """The batch of ``step``: tokens and labels, or for a stub front
        end (``embeds``, ``encdec``) 0.02 N(0, 1) embeddings of width
        ``d_model`` from a stream of their own."""
        c = self.cfg
        batch = lm_batch(c.seed, step, c.global_batch, c.seq_len, c.vocab,
                         device=self.device)
        if c.input_kind in ("embeds", "encdec"):
            gen = step_generator(c.seed, step, _EMBED_STREAM)
            emb = 0.02 * torch.randn((c.global_batch, c.seq_len, c.d_model),
                                     generator=gen)
            emb = emb.to(self.device)
            if c.input_kind == "embeds":
                return {"embeds": emb, "labels": batch["labels"]}
            return {"enc_embeds": emb, **batch}
        return batch

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1
