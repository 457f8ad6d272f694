"""The one generator every traffic mix is read by.

A mix is a data file (``traffic/<name>.json``) of parameters: the
driver it feeds (a module of ``drivers/``), the seed batch and group,
the fanouts, the node-capacity rule, the warm-up and check sizes and
the traced stretch.  From the run's seed this module draws the seed
order: epochs back to back over the train split, each shuffled anew,
cut into ``[group, batch_size]`` blocks padded with -1, each block under
its own threefry key index.  Every seed gets the same sizes and the same
block count per epoch; only the order and the keys move with the seed.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

# Independent streams drawn from one run seed.
STREAMS = ("graph", "weights", "order", "keys", "check", "warm")


def sub_seeds(seed: int) -> dict:
    """One 31-bit seed per stream, from the run's seed (any size)."""
    words = np.random.SeedSequence(int(seed)).generate_state(len(STREAMS))
    return {name: int(w) & 0x7FFFFFFF for name, w in zip(STREAMS, words)}


def epoch_blocks(train_idx: np.ndarray, batch_size: int, group: int,
                 rng: np.random.Generator) -> Iterator[np.ndarray]:
    """One shuffled epoch of ``[group, batch_size]`` int64 blocks, -1
    padded at the end."""
    ids = train_idx[rng.permutation(train_idx.shape[0])]
    per_block = batch_size * group
    for lo in range(0, ids.shape[0], per_block):
        blk = np.full((group, batch_size), -1, np.int64)
        chunk = ids[lo: lo + per_block]
        blk.reshape(-1)[: chunk.shape[0]] = chunk
        yield blk


def blocks(train_idx: np.ndarray, mix: dict, seed: int
           ) -> Iterator[Tuple[int, np.ndarray]]:
    """``(block index, block)`` over epochs without end, in the order the
    seed draws."""
    rng = np.random.default_rng(sub_seeds(seed)["order"])
    i = 0
    while True:
        for blk in epoch_blocks(train_idx, int(mix["batch_size"]),
                                int(mix["group"]), rng):
            yield i, blk
            i += 1


def distinct_batches(train_idx: np.ndarray, count: int, batch_size: int,
                     seed: int, stream: str) -> np.ndarray:
    """``[count, batch_size]`` seed ids, all distinct, drawn from one of
    the seed's streams (the check and warm-up batches)."""
    rng = np.random.default_rng(sub_seeds(seed)[stream])
    need = count * batch_size
    if need > train_idx.shape[0]:
        raise ValueError(f"{need} distinct seeds from a split of "
                         f"{train_idx.shape[0]}")
    pick = rng.choice(train_idx.shape[0], size=need, replace=False)
    return train_idx[pick].reshape(count, batch_size)
