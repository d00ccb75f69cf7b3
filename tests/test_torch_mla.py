"""The port's multi-head latent attention (MLA, deepseek-v3) against the JAX
package: the decompressed prefill, the latent cache as written, decode
steps that recompute k and v from the cached latent, and the refusals JAX
makes.  deepseek-smoke in f32; params made by JAX and converted with
`params_from_jax`; activations from a seed with numpy.  Tolerance 2e-5
(abs and rel): both sides in f32, sums in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.models import init_caches as jax_init_caches
from repro.models import init_lm as jax_init_lm
from repro.models.attention import apply_mla as jax_apply_mla
from repro.models.attention import init_mla as jax_init_mla
from repro.models.blocks import kv_cache_dtype as jax_kv_cache_dtype
from repro.serving.engine import Engine as JaxEngine
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import init_caches, init_lm
from repro_torch.models.attention import apply_attention, apply_mla, init_mla
from repro_torch.models.blocks import kv_cache_dtype
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import Engine

TOL = dict(atol=2e-5, rtol=2e-5)
ARCH = "deepseek-v3-671b"


@pytest.fixture(scope="module")
def mla():
    """(jax cfg, jax MLA params, port cfg, port MLA params)."""
    jcfg = jax_get_smoke_config(ARCH)
    jp = jax_init_mla(jax.random.PRNGKey(3), jcfg)
    return jcfg, jp, get_smoke_config(ARCH), jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)), jp)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_init_mla_shapes(mla):
    jcfg, jp, cfg, _ = mla
    mine = init_mla(torch.Generator().manual_seed(0), cfg)
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}


def test_prefill_without_cache(mla):
    jcfg, jp, cfg, p = mla
    x = _x((2, 11, cfg.d_model))
    pos = np.arange(11, dtype=np.int32)
    want, _ = jax_apply_mla(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos))
    got, cache = apply_mla(p, torch.from_numpy(x), cfg, positions=torch.from_numpy(pos))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("prompt,steps", [(9, 3), (16, 1)])
def test_prefill_then_decode_with_latent_cache(mla, prompt, steps):
    """A prefill written into the latent cache at index 0 (the post-rotary
    latent), then single-token decode steps at int indices, each reading k
    and v back from the whole cached latent; outputs and the cache as
    written after every call."""
    jcfg, jp, cfg, p = mla
    b, s_max, width = 2, 24, cfg.kv_lora_rank + cfg.qk_rope_dim
    jcache = {"latent": jnp.zeros((b, s_max, width), jnp.float32)}
    cache = {"latent": torch.zeros(b, s_max, width)}
    x = _x((b, prompt, cfg.d_model), seed=prompt)
    pos = np.arange(prompt, dtype=np.int32)
    want, jcache = jax_apply_mla(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                                 cache=jcache, cache_index=0)
    got, out_cache = apply_mla(p, torch.from_numpy(x), cfg, positions=torch.from_numpy(pos),
                               cache=cache, cache_index=0)
    assert out_cache is cache                       # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(cache["latent"].numpy(), np.asarray(jcache["latent"]), **TOL)
    for i in range(steps):
        idx = prompt + i
        xt = _x((b, 1, cfg.d_model), seed=100 + i)
        want, jcache = jax_apply_mla(jp, jnp.asarray(xt), jcfg, positions=jnp.asarray([idx]),
                                     cache=jcache, cache_index=idx)
        got, _ = apply_mla(p, torch.from_numpy(xt), cfg, positions=torch.tensor([idx]),
                           cache=cache, cache_index=idx)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(cache["latent"].numpy(), np.asarray(jcache["latent"]),
                                   **TOL)


def test_per_row_cache_index_raises_as_in_jax(mla):
    """JAX's `dynamic_update_slice` takes one write offset for every row, so
    a per-row (vector) cache_index fails there; the port refuses it too."""
    jcfg, jp, cfg, p = mla
    width = cfg.kv_lora_rank + cfg.qk_rope_dim
    ci = np.asarray([3, 5], np.int32)
    with pytest.raises(TypeError):
        jax_apply_mla(jp, jnp.ones((2, 1, cfg.d_model)), jcfg, positions=jnp.asarray(ci)[:, None],
                      cache={"latent": jnp.zeros((2, 16, width))}, cache_index=jnp.asarray(ci))
    with pytest.raises(ValueError, match="int cache_index"):
        apply_mla(p, torch.ones(2, 1, cfg.d_model), cfg, positions=torch.from_numpy(ci)[:, None],
                  cache={"latent": torch.zeros(2, 16, width)}, cache_index=torch.from_numpy(ci))


def test_latent_cache_layout():
    """init_caches: {"latent": (n, b, s_max, kv_lora_rank + qk_rope_dim)}
    per attention segment, as JAX's (with the layer axis leading)."""
    jcfg, cfg = jax_get_smoke_config(ARCH), get_smoke_config(ARCH)
    want = jax_init_caches(jcfg, 2, 16, jnp.float32)
    got = init_caches(cfg, 2, 16, torch.float32)
    assert [{k: tuple(v.shape) for k, v in seg.items()} for seg in got] == \
        [{k: tuple(v.shape) for k, v in seg.items()} for seg in want]
    assert tuple(got[0]["latent"].shape) == (1, 2, 16, cfg.kv_lora_rank + cfg.qk_rope_dim)


def test_refusals_match_jax(mla):
    """MLA with an int8 KV cache, MLA in the serving engine and MLA with
    block tables raise, on both sides."""
    jcfg, jp, cfg, p = mla
    for c, kv in ((jcfg, jax_kv_cache_dtype), (cfg, kv_cache_dtype)):
        with pytest.raises(ValueError, match="not supported with attn_type='mla'"):
            kv(dataclasses.replace(c, kv_dtype="int8"), None)
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(NotImplementedError, match="MLA"):
        JaxEngine(jparams, jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    with pytest.raises(NotImplementedError, match="MLA"):
        Engine(params, cfg, device="cpu")
    x = jnp.ones((1, 1, cfg.d_model))
    with pytest.raises(AssertionError, match="not supported for MLA"):
        from repro.models.attention import apply_attention as jax_apply_attention
        jax_apply_attention(jp, x, jcfg, positions=jnp.asarray([0]),
                            block_tables=jnp.zeros((1, 1), jnp.int32))
    with pytest.raises(ValueError, match="not supported for MLA"):
        apply_attention(p, torch.ones(1, 1, cfg.d_model), cfg, positions=torch.tensor([0]),
                        block_tables=torch.zeros(1, 1, dtype=torch.int32))
    # the port's own init of a whole MLA model has the latent-cache layout
    assert "wkv_down" in init_lm(None, cfg, device="meta")["seg0"]["attn"]
