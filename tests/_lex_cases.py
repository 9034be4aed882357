"""Inputs of the (d, id) selection tests, made with numpy from a seed so
that the CPU tests (against the JAX package) and the card's tests
(tests/test_torch_gpu.py, jax-free) select over the same values.

Each case is scores d [B, R] f32, shared ids [R] int32 (-1 = masked,
real ids distinct) and kk."""

import numpy as np

LEX_CASES = ("ties", "masked_kk_eq_r", "all_masked", "kk1024", "negative")


def lex_case(name: str) -> tuple:
    rng = np.random.default_rng(LEX_CASES.index(name))
    if name == "ties":  # small integers: most distances tie, ids decide
        d = rng.integers(0, 6, (5, 300)).astype(np.float32)
        ids = rng.permutation(900)[:300].astype(np.int32)
        ids[::7] = -1
        return d, ids, 100
    if name == "masked_kk_eq_r":  # kk = R: every masked slot comes back
        d = rng.normal(size=(3, 60)).astype(np.float32) * 10 + 40
        ids = rng.permutation(60).astype(np.int32)
        ids[rng.random(60) < 0.3] = -1
        return d, ids, 60
    if name == "all_masked":
        d = rng.normal(size=(2, 50)).astype(np.float32)
        return d, np.full(50, -1, np.int32), 30
    if name == "kk1024":  # the largest selection, ties across it
        d = rng.integers(0, 9, (2, 1100)).astype(np.float32)
        ids = rng.permutation(5000)[:1100].astype(np.int32)
        ids[::9] = -1
        return d, ids, 1024
    if name == "negative":  # negative distances, -0 beside +0
        d = rng.normal(size=(4, 500)).astype(np.float32)
        d[:, ::11] = -0.0
        d[:, 5::11] = 0.0
        ids = rng.permutation(500).astype(np.int32)
        ids[::13] = -1
        return d, ids, 200
    raise KeyError(name)
