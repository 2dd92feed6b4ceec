"""Deterministic synthetic data pipelines.

No network access in this container, so every experiment runs on procedural
data: a Zipf-ish Markov token stream for LM training (compressible -> loss
actually decreases), frame/patch embeddings for the stub frontends, and a
separable shapes-classification task for the CNN accuracy-drop calibration.

Multihost-shaped API: `lm_batch(..., process_index, process_count)` yields
this host's shard of the global batch; per-step seeding keeps every host
deterministic and disjoint without coordination (restart-safe: data is a
pure function of (seed, step)).
"""

from __future__ import annotations

import numpy as np


def _rng(seed: int, step: int, stream: int = 0) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, step, stream]))


def lm_batch(vocab: int, batch: int, seq: int, step: int, seed: int = 0,
             process_index: int = 0, process_count: int = 1) -> dict:
    """Markov-chain token stream: P(next | cur) concentrated on a few
    successors, so cross-entropy has real structure to learn."""
    assert batch % process_count == 0
    local = batch // process_count
    rng = _rng(seed, step, process_index)
    # deterministic per-vocab successor table (seed-level, step-free)
    table_rng = _rng(seed, 0, 10_000)
    successors = table_rng.integers(0, vocab, size=(vocab, 4))
    toks = np.empty((local, seq), np.int32)
    cur = rng.integers(0, vocab, size=local)
    for t in range(seq):
        toks[:, t] = cur
        branch = rng.random(local)
        nxt = successors[cur, rng.integers(0, 4, size=local)]
        rand = rng.integers(0, vocab, size=local)
        cur = np.where(branch < 0.85, nxt, rand)
    labels = np.concatenate([toks[:, 1:], np.zeros((local, 1), np.int32)], 1)
    mask = np.ones((local, seq), np.float32)
    mask[:, -1] = 0
    return {"tokens": toks, "labels": labels, "mask": mask}


def frames_batch(batch: int, enc_seq: int, d_model: int, step: int,
                 seed: int = 0) -> np.ndarray:
    rng = _rng(seed, step, 1)
    return rng.standard_normal((batch, enc_seq, d_model)).astype(np.float32)


def img_batch(batch: int, n_tokens: int, d_model: int, step: int,
              seed: int = 0) -> np.ndarray:
    rng = _rng(seed, step, 2)
    return (rng.standard_normal((batch, n_tokens, d_model)) * 0.1
            ).astype(np.float32)


# --- CNN calibration task -------------------------------------------------------

def shapes_classification(n: int, image: int = 32, n_classes: int = 4,
                          seed: int = 0, amplitude: float = 2.5,
                          noise: float = 0.3
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Procedural image classification: class = which quadrant holds a
    bright blob + global orientation of a gradient.  Linearly non-trivial,
    CNN-learnable in a few hundred steps on CPU.  Lower `amplitude` /
    higher `noise` makes the task margin-sensitive, so approximate-
    multiplier error produces measurable accuracy drops (the calibration
    benchmark uses that regime)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, image, image, 3)).astype(np.float32) * noise
    y = rng.integers(0, n_classes, size=n)
    yy, xx = np.mgrid[0:image, 0:image].astype(np.float32) / image
    grid = max(2, int(np.ceil(np.sqrt(max(n_classes // 2, 2)))))
    for i in range(n):
        c = y[i]
        pos = c % (grid * grid)
        cy = image * (2 * (pos % grid) + 1) // (2 * grid)
        cx = image * (2 * (pos // grid) + 1) // (2 * grid)
        blob = np.exp(-(((np.arange(image) - cy)[:, None] / 4.0) ** 2
                        + ((np.arange(image) - cx)[None, :] / 4.0) ** 2))
        x[i, :, :, 0] += amplitude * blob.astype(np.float32)
        x[i, :, :, 1] += (yy if c % 2 else xx) * 0.8
    return x, y.astype(np.int32)


def batch_for(cfg, shape_kind: str, batch: int, seq: int, step: int,
              seed: int = 0) -> dict:
    """Assemble the full input dict for a ModelConfig."""
    out = lm_batch(cfg.vocab, batch, seq, step, seed)
    if cfg.family == "encdec":
        out["frames"] = frames_batch(batch, cfg.enc_seq, cfg.d_model, step,
                                     seed)
    if cfg.cross_every:
        out["img"] = img_batch(batch, cfg.n_img_tokens, cfg.d_model, step,
                               seed)
    return out
