"""repro_torch's generate loop against the JAX package's, on the CPU: greedy
tokens equal in f32 from the reference's weights carried over by
``params_from_jax`` (the first maximum on both sides), and temperature
sampling reproducible from a torch.Generator (the reference draws from jax
keys, which torch cannot reproduce).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import model as JM
from repro.models.params import initialize as jinitialize
from repro.serve.serve_step import generate as jgenerate
from repro_torch.configs import get_smoke_config
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.serve_step import build_decode_step, generate


def _pair(arch, **over):
    jcfg = dataclasses.replace(jget_smoke(arch), param_dtype=jnp.float32,
                               compute_dtype=jnp.float32, **over)
    cfg = dataclasses.replace(get_smoke_config(arch),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32, **over)
    jp = jinitialize(JM.model_specs(jcfg), jax.random.PRNGKey(0))
    return jcfg, jp, cfg, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")


@pytest.mark.parametrize("arch,s,n", [("gemma2-2b", 6, 8),
                                      ("minitron-8b", 6, 8)])
def test_greedy_tokens_equal_reference(arch, s, n):
    """gemma2's smoke window is 8: 6 + 8 positions decode past it."""
    jcfg, jp, cfg, model = _pair(arch)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (3, s)).astype(np.int32)
    want, _ = jgenerate(jp, jcfg, jnp.asarray(prompt), n)
    got, aux = generate(model, cfg, prompt, n)
    assert got.dtype == torch.int32 and got.shape == (3, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the cache was allocated at capacity s + n up front
    assert aux["cache"]["blocks"]["sub0"]["k"].shape[2] == s + n


def test_sampling_is_reproducible_from_a_generator():
    """minitron's smoke logits are spread (gemma2's random weights give
    softcapped logits whose softmax is one token)."""
    _, _, cfg, model = _pair("minitron-8b")
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 5)).astype(np.int32)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        toks, _ = generate(model, cfg, prompt, 10, sample="categorical",
                           generator=g)
        return toks

    a, b, c = run(7), run(7), run(8)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert bool(((a >= 0) & (a < cfg.vocab_size)).all())
    greedy, _ = generate(model, cfg, prompt, 10)
    # the first token is the prefill's argmax, sampled or not, as the
    # reference's generate takes it
    assert torch.equal(a[:, 0], greedy[:, 0])
    assert not torch.equal(a, greedy)


def test_temperature_sampling_follows_the_distribution(monkeypatch):
    """Draws at temperature T from fixed logits land on each token about
    as often as softmax(logits / T) says."""
    import repro_torch.serve.serve_step as ss

    logits = torch.tensor([[[0.0, 1.0, 2.0, -30.0]]]).repeat(4000, 1, 1)
    monkeypatch.setattr(ss.model_mod, "decode_step",
                        lambda *a: (logits, None))
    step = build_decode_step(get_smoke_config("gemma2-2b"),
                             sample="categorical", temperature=2.0)
    nxt, _, _ = step(None, None, None, 0, torch.Generator().manual_seed(0))
    freq = torch.bincount(nxt.long(), minlength=4).float() / 4000
    want = torch.softmax(logits[0, 0] / 2.0, dim=-1)
    torch.testing.assert_close(freq, want, atol=0.03, rtol=0.0)
