"""Seedable module-level RNG for the simulators (the port's copy of
bionumpy_tpu/simulate/rng.py; reference: bionumpy/simulate/rng.py)."""
import numpy as np

_bionumpy_random_seed = None


def seed(seed: int):
    global _bionumpy_random_seed
    _bionumpy_random_seed = seed


def default_rng() -> np.random.Generator:
    return np.random.default_rng(_bionumpy_random_seed)
