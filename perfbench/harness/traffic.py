"""What a traffic mix (a JSON file under ``perfbench/traffic/``) and a
seed give a cell: the seeded random streams its inputs are drawn from,
and, for a CURing mix, the order in which the selected layers are
compressed.
"""
from __future__ import annotations

import itertools
from typing import Dict, Iterator, Sequence

import numpy as np


def rng_for(seed: int, stream: int = 0) -> np.random.Generator:
    """A numpy generator for any whole ``seed`` (also beyond 64 bits)."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), stream])


def layer_stream(mix: Dict, layers: Sequence[int]) -> Iterator[int]:
    """The layers a CURing mix compresses, one a step: ``round_robin``
    cycles through the selected layers in index order."""
    if mix.get("arrival") != "layers" or mix.get("order") != "round_robin":
        raise ValueError(f"not a CURing mix: {mix!r}")
    return itertools.cycle(sorted(layers))
