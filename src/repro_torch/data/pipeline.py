"""Deterministic, checkpointable data pipeline (mirrors
src/repro/data/pipeline.py; the numpy generators are the reference's,
byte for byte).

``SyntheticLM`` generates a learnable affine-Markov token stream: the
cursor is just the step number, so a restart from a checkpoint replays
the same batches.  ``token_file_reader`` is the file-backed path (a
memmap of uint16/uint32 tokens) with the same cursor semantics.
``make_batch_for`` puts a batch on the model's device (int32, as the
reference's).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05            # fraction of non-Markov tokens
    mult: int = 31                 # affine map: next = (mult*t + 7) % vocab


class SyntheticLM:
    """Learnable synthetic LM stream; batch(step) is a pure function."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng((c.seed << 32) ^ step)
        b, s = c.global_batch, c.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, c.vocab, size=b)
        noise = rng.random((b, s)) < c.noise
        rand = rng.integers(0, c.vocab, size=(b, s))
        for t in range(s):
            nxt = (toks[:, t] * c.mult + 7) % c.vocab
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def token_file_reader(path: str, seq_len: int, global_batch: int,
                      dtype=np.uint16):
    """Memmap token-file reader; cursor = step (deterministic restart).
    Returns (batch(step), n_steps)."""
    data = np.memmap(path, dtype=dtype, mode="r")
    per_batch = seq_len * global_batch + 1
    n_steps = (len(data) - 1) // (seq_len * global_batch)

    def batch(step: int) -> Dict[str, np.ndarray]:
        ofs = (step % n_steps) * seq_len * global_batch
        chunk = np.asarray(data[ofs: ofs + per_batch], np.int32)
        toks = chunk[:-1].reshape(global_batch, seq_len)
        labs = chunk[1:].reshape(global_batch, seq_len)
        return {"tokens": toks, "labels": labs}

    return batch, n_steps


def make_batch_for(cfg: ModelConfig, data: Dict[str, np.ndarray], *,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """A raw token batch as the model's input dict on ``device`` (the card
    unless the caller asks for the CPU).  The reference also builds the
    modality stubs of its encoder-decoder and patch-frontend families
    (from its ``prefix_rng``); the port trains the GQA decoder family,
    whose input is the tokens alone (its other families serve, and
    training them is ROADMAP item A12)."""
    if cfg.family != "decoder" or cfg.frontend != "none":
        what = f"the {cfg.family!r} family"
        if cfg.frontend != "none":
            what += f" with a {cfg.frontend!r} frontend"
        raise NotImplementedError(
            f"{cfg.name}: the port trains the GQA decoder family (MLA "
            f"included); training {what} is ROADMAP item A12")
    return {k: torch.as_tensor(np.asarray(data[k], np.int32), device=device)
            for k in ("tokens", "labels")}
