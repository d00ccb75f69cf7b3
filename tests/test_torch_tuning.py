"""The port's tuning loop on the CPU: the cache file both packages share,
each wrapper's geometry choice (the cache's entry on a hit, the wrapper's
rule on a miss) and its lookup memo, the search loop with its timer
replaced by fixed times, the advisor's bucket growth and the engine's
block-size pick against JAX's at the H100, the linear dispatch's tuned
flags, and the train launcher's advisor report.

Every test that writes a cache uses `tmp_path`, and every test that
installs a default cache restores none afterwards (`installed`).
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.core import advisor as jax_advisor
from repro.core.gemm_model import MeasuredProfile as JaxMeasuredProfile
from repro.core.hardware import H100_SXM as JAX_H100
from repro.models import init_lm as jax_init_lm
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine.buckets import make_policy as jax_make_policy
from repro.tuning import cache as jax_cache
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.core.gemm_model import MeasuredProfile
from repro_torch.core.hardware import H100_SXM
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.fused_mlp import ops as fused_ops
from repro_torch.kernels.matmul import ops as matmul_ops
from repro_torch.kernels.matmul.ref import matmul_ref
from repro_torch.kernels.quantized import ops as quant_ops
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import Engine
from repro_torch.serving.engine.buckets import make_policy
from repro_torch.tuning import cache as port_cache
from repro_torch.tuning import candidates, search
from repro_torch.tuning.cache import (TunedConfig, TuningCache, cache_key, dtype_name,
                                      get_default_cache, lookup, mixed_dtype, set_default_cache)
from repro_torch.tuning.measure import time_ms, wall_us

ARCH = "internlm2-1.8b"


@pytest.fixture
def installed():
    """An empty default cache for the test; none installed afterwards."""
    cache = TuningCache()
    set_default_cache(cache)
    yield cache
    set_default_cache(None)


def _entry(op, shape, dtype, blocks, hw="h100", us=10.0):
    return TunedConfig(op=op, shape=tuple(shape), dtype=dtype, hw_name=hw, blocks=blocks,
                       time_us=us, baseline_us=2 * us, candidates_tried=4, time_us_std=0.25)


# --- the cache file -----------------------------------------------------------------

def _fill(cache_mod, cache):
    for op, shape, dtype, blocks, hw in [
            ("matmul", (64, 2048, 2048), "bfloat16",
             {"block_m": 64, "block_n": 128, "split_k": 8}, "h100"),
            ("matmul", (512, 512, 512), "float32",
             {"block_m": 512, "block_n": 256, "block_k": 128}, "tpu_v5e"),
            ("int8_matmul", (128, 2048, 2048), "bfloat16xint8",
             {"block_m": 64, "block_n": 128, "split_k": 4}, "h100"),
            ("paged_decode_blocktable_pool", (64, 64, 192, 8, 16, 128), "bfloat16",
             {"block_size": 32, "tile": 64, "splits": 2}, "h100")]:
        cache.put(cache_mod.TunedConfig(op=op, shape=shape, dtype=dtype, hw_name=hw,
                                        blocks=blocks, time_us=12.5, baseline_us=15.0,
                                        candidates_tried=8, time_us_std=0.5))


def test_cache_files_cross_load_and_save_the_same_bytes(tmp_path):
    """A cache saved by either package loads in the other and saves to the
    same bytes; TPU and H100 entries sit side by side."""
    jc = jax_cache.TuningCache()
    _fill(jax_cache, jc)
    pc = TuningCache()
    _fill(port_cache, pc)
    jpath, ppath = tmp_path / "jax.json", tmp_path / "port.json"
    jc.save(str(jpath))
    pc.save(str(ppath))
    assert jpath.read_bytes() == ppath.read_bytes()
    port_from_jax, jax_from_port = TuningCache.load(str(jpath)), jax_cache.TuningCache.load(
        str(ppath))
    port_from_jax.save(str(tmp_path / "a.json"))
    jax_from_port.save(str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes() == \
        jpath.read_bytes()
    assert len(port_from_jax.by_op("matmul")) == 2
    assert len(port_from_jax.by_op("matmul", "h100")) == 1
    assert cache_key("matmul", (64, 2048, 2048), "bfloat16", "h100") == jax_cache.cache_key(
        "matmul", (64, 2048, 2048), "bfloat16", "h100")
    assert port_cache.CACHE_VERSION == jax_cache.CACHE_VERSION
    assert (port_cache.ENV_VAR, port_cache.DEFAULT_FILENAME) == (
        jax_cache.ENV_VAR, jax_cache.DEFAULT_FILENAME)
    bad = tmp_path / "v2.json"
    bad.write_text(json.dumps({"version": 2, "entries": {}}))
    with pytest.raises(ValueError, match="version"):
        TuningCache.load(str(bad))


def test_dtype_names_are_jax_names():
    for dt in (torch.float32, torch.bfloat16, torch.float16, torch.int8, torch.float8_e4m3fn,
               torch.float8_e5m2):
        assert dtype_name(dt) == jax.numpy.dtype(str(dt).removeprefix("torch.")).name
    assert mixed_dtype("bfloat16", "int8") == "bfloat16xint8"
    assert mixed_dtype("bfloat16", "bfloat16") == "bfloat16"
    with pytest.raises(ValueError, match="no tuning-cache name"):
        dtype_name(torch.complex64)


def test_lookup_memo_clears_on_install_reload_and_put(installed, tmp_path, monkeypatch):
    key = ("matmul", (64, 2048, 2048), "bfloat16", "h100")
    assert lookup(*key) is None
    installed.put(_entry(*key[:3], {"block_m": 128, "block_n": 128, "split_k": 2}))
    assert lookup(*key).blocks["split_k"] == 2                 # put cleared the memo
    other = TuningCache()
    set_default_cache(other)
    assert lookup(*key) is None                                # install cleared it
    path = tmp_path / "env.json"
    installed.save(str(path))
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(path))
    assert lookup(*key) is None                                # still the installed one
    assert get_default_cache(reload=True).path == str(path)
    assert lookup(*key).blocks["split_k"] == 2                 # reload cleared it
    set_default_cache(str(path))
    assert lookup(*key[:3], "a100") is None


# --- the wrappers' geometry ---------------------------------------------------------

def test_matmul_geometry_hit_and_miss(installed):
    for m, k, n, dt in ((64, 2048, 2048, torch.bfloat16), (256, 8192, 2048, torch.bfloat16),
                        (64, 2048, 2048, torch.float32)):
        rule = matmul_ops.launch_shape(m, n, k, dt, 132)
        assert matmul_ops.geometry(m, k, n, dt, tuned=True) == (rule, None)
        installed.put(_entry("matmul", (m, k, n), dtype_name(dt),
                             {"block_m": 128, "block_n": 128, "split_k": 2}))
        geo, cfg = matmul_ops.geometry(m, k, n, dt, tuned=True)
        assert geo == (128, 128, k // 2) and cfg.blocks["split_k"] == 2
        assert matmul_ops.geometry(m, k, n, dt, tuned=False) == (rule, None)
        assert matmul_ops.geometry(m, k, n, dt, tuned=True, hw_name="a100") == (rule, None)
        assert matmul_ops.geometry(m, k, n, dt, tuned=True, num_sms=100)[0] == geo
    # the emulated fp8 GEMM's entries, under their own op and mixed dtype
    key = mixed_dtype("bfloat16", "float8_e4m3fn")
    assert matmul_ops.geometry(64, 2048, 2048, torch.bfloat16, tuned=True, op="fp8_matmul",
                               key_dtype=key)[1] is None
    installed.put(_entry("fp8_matmul", (64, 2048, 2048), key,
                         {"block_m": 64, "block_n": 128, "split_k": 1}))
    assert matmul_ops.geometry(64, 2048, 2048, torch.bfloat16, tuned=True, op="fp8_matmul",
                               key_dtype=key)[0] == (64, 128, 2048)


def test_fused_and_int8_geometry_hit_and_miss(installed):
    assert fused_ops.geometry(64, 2048, 8192, torch.bfloat16, "swiglu", tuned=True) == \
        ((64, 64), None)
    installed.put(_entry("fused_mlp_swiglu", (64, 2048, 8192), "bfloat16",
                         {"block_m": 128, "block_f": 128}))
    assert fused_ops.geometry(64, 2048, 8192, torch.bfloat16, "swiglu", tuned=True)[0] == \
        (128, 128)
    assert fused_ops.geometry(64, 2048, 8192, torch.bfloat16, "gelu", tuned=True)[1] is None

    rule = quant_ops.launch_shape(128, 2048, 2048, 132)
    assert quant_ops.int8_geometry(128, 2048, 2048, torch.bfloat16, tuned=True) == (rule, None)
    installed.put(_entry("int8_matmul", (128, 2048, 2048), "bfloat16xint8",
                         {"block_m": 64, "block_n": 128, "split_k": 4}))
    assert quant_ops.int8_geometry(128, 2048, 2048, torch.bfloat16, tuned=True)[0] == \
        (64, 128, 512)
    assert quant_ops.int8_geometry(128, 2048, 2048, torch.float32, tuned=True) == (rule, None)

    assert quant_ops.int8_fused_geometry(256, 2048, 8192, torch.bfloat16, "swiglu",
                                         tuned=True) == ((128, 32), None)
    installed.put(_entry("int8_fused_mlp_swiglu", (256, 2048, 8192), "bfloat16xint8",
                         {"block_m": 64, "block_f": 32}))
    assert quant_ops.int8_fused_geometry(256, 2048, 8192, torch.bfloat16, "swiglu",
                                         tuned=True)[0] == (64, 32)


def test_paged_geometry_hit_and_miss(installed):
    slot = ("paged_decode", (64, 64, 128, 8, 16, 128))
    rule = flash_ops.paged_launch(64, 8, 2, 128, 128, 2)
    assert flash_ops.paged_geometry(*slot, torch.bfloat16, torch.bfloat16, 64, 8, 2, 128, 128,
                                    tuned=True) == (rule, None)
    installed.put(_entry(*slot, "bfloat16", {"tile": 64, "splits": 2}))
    geo, cfg = flash_ops.paged_geometry(*slot, torch.bfloat16, torch.bfloat16, 64, 8, 2, 128,
                                        128, tuned=True)
    assert geo == flash_ops.paged_launch(64, 8, 2, 128, 128, 2, 2, 64, 2) and cfg is not None
    # an int8 pool keys the mixed dtype; f32 queries have no knob and look nothing up
    assert flash_ops.paged_geometry(*slot, torch.bfloat16, torch.int8, 64, 8, 2, 128, 128,
                                    tuned=True)[1] is None
    installed.put(_entry(*slot, "bfloat16xint8", {"tile": 32, "splits": 4}))
    assert flash_ops.paged_geometry(*slot, torch.bfloat16, torch.int8, 64, 8, 2, 128, 128,
                                    tuned=True)[0].tile == 32
    installed.put(_entry(*slot, "float32", {"tile": 64, "splits": 2}))
    assert flash_ops.paged_geometry(*slot, torch.float32, torch.float32, 64, 8, 2, 128, 128,
                                    tuned=True) == (flash_ops.paged_launch(64, 8, 2, 128, 128, 4,
                                                                           4), None)
    table = ("paged_decode_blocktable", (64, 193, 64, 8, 16, 128))
    installed.put(_entry(*table, "bfloat16", {"tile": 32, "splits": 3}))
    geo, cfg = flash_ops.paged_geometry(*table, torch.bfloat16, torch.bfloat16, 64, 8, 2, 128,
                                        192, tuned=True)
    assert (geo.tile, geo.splits) == (32, 3) and cfg.blocks["splits"] == 3


def test_wrappers_on_the_cpu_ignore_the_cache(installed):
    """A CPU tensor runs the plain version whatever the cache says (here an
    entry naming a tile no kernel has) and counts no lookup."""
    gen = torch.Generator().manual_seed(0)
    a, b = torch.randn(5, 48, generator=gen), torch.randn(48, 40, generator=gen)
    installed.put(_entry("matmul", (5, 48, 40), "float32",
                         {"block_m": 96, "block_n": 96, "split_k": 3}))
    before = (matmul_ops.matmul.launches, matmul_ops.matmul.tuned_hits,
              matmul_ops.matmul.tuned_misses)
    assert torch.equal(matmul_ops.matmul(a, b, tuned=True), matmul_ref(a, b))
    assert (matmul_ops.matmul.launches, matmul_ops.matmul.tuned_hits,
            matmul_ops.matmul.tuned_misses) == before


# --- the search loop ----------------------------------------------------------------

SEARCHES = [
    (search.autotune_matmul, (64, 2048, 2048), "matmul", (64, 2048, 2048), "bfloat16",
     lambda: candidates.matmul_candidates(64, 2048, 2048), ("block_m", "block_n", "split_k")),
    (search.autotune_fused_mlp, (64, 256, 512), "fused_mlp_swiglu", (64, 256, 512), "bfloat16",
     lambda: candidates.fused_mlp_candidates(64, 256, 512), ("block_m", "block_f")),
    (search.autotune_int8_matmul, (128, 2048, 1024), "int8_matmul", (128, 2048, 1024),
     "bfloat16xint8", lambda: candidates.int8_matmul_candidates(128, 2048, 1024),
     ("block_m", "block_n", "split_k")),
    (search.autotune_fp8_matmul, (16, 512, 256), "fp8_matmul", (16, 512, 256),
     "bfloat16xfloat8_e4m3fn", lambda: candidates.fp8_matmul_candidates(16, 512, 256),
     ("block_m", "block_n", "split_k")),
    (search.autotune_int8_fused_mlp, (64, 256, 512), "int8_fused_mlp_swiglu", (64, 256, 512),
     "bfloat16xint8", lambda: candidates.int8_fused_mlp_candidates(64, 256, 512),
     ("block_m", "block_f")),
    (search.autotune_paged_decode, (8, 8, 128, 2, 4, 16), "paged_decode",
     (8, 8, 128, 2, 4, 16), "bfloat16",
     lambda: candidates.paged_decode_candidates(8, 2, 2, 16, 128), ("tile", "splits")),
]


@pytest.mark.parametrize("fn,args,op,shape,dtype,cands,names", SEARCHES,
                         ids=[s[2] for s in SEARCHES])
def test_search_loop_with_fixed_times(fn, args, op, shape, dtype, cands, names, monkeypatch):
    """The second candidate is fastest: it wins; the first (the rule's
    pick) is the baseline; every candidate is tried once."""
    lattice = cands()
    assert len(lattice) >= 2
    times = iter([7.0, 2.0] + [5.0 + i for i in range(len(lattice))])
    calls = []

    def fake(op_name, f, *a, iters, warmup):
        calls.append(op_name)
        return next(times), 0.25
    monkeypatch.setattr(search, "_measure", fake)
    cache = TuningCache()
    monkeypatch.setattr(search, "DEVICE", "cpu")
    cfg = fn(*args, cache=cache)
    assert calls == [op] * len(lattice)
    assert cfg.blocks == dict(zip(names, lattice[1]))
    assert (cfg.op, cfg.shape, cfg.dtype, cfg.hw_name) == (op, shape, dtype, "h100")
    assert (cfg.time_us, cfg.baseline_us, cfg.candidates_tried, cfg.time_us_std) == \
        (2.0, 7.0, len(lattice), 0.25)
    assert cache.get(op, shape, dtype, "h100") == cfg
    assert cfg.speedup_vs_default == 3.5


def test_blocktable_search_writes_pool_and_kernel_entries(monkeypatch):
    lattice = candidates.paged_blocktable_candidates(8, 2, 2, 16, 192)
    sizes = sorted({c[0] for c in lattice}, reverse=True)
    assert sizes == [64, 32, 16]
    win = lattice.index(next(c for c in lattice if c[0] == 32)) + 1
    times = iter([9.0 - 0.001 * i if i != win else 1.0 for i in range(len(lattice))])
    monkeypatch.setattr(search, "_measure", lambda *a, iters, warmup: (next(times), 0.0))
    monkeypatch.setattr(search, "DEVICE", "cpu")
    cache = TuningCache()
    cfg = search.autotune_paged_decode_blocktable(8, 8, 192, 2, 4, 16, cache=cache)
    assert cfg.op == "paged_decode_blocktable_pool" and cfg.shape == (8, 8, 192, 2, 4, 16)
    assert cfg.blocks == dict(zip(("block_size", "tile", "splits"), lattice[win]))
    assert cfg.candidates_tried == len(lattice)
    # the baseline: the engine's fallback block size (64 on the H100) at the kernel's rule
    assert cfg.baseline_us == 9.0
    for bs in sizes:
        e = cache.get("paged_decode_blocktable", (8, 8 * 192 // bs, bs, 2, 4, 16), "bfloat16",
                      "h100")
        assert set(e.blocks) == {"tile", "splits"}
    assert len(cache) == 1 + len(sizes)


def test_autotune_on_the_cpu_raises(monkeypatch):
    monkeypatch.setattr(search, "DEVICE", "cpu")
    with pytest.raises(RuntimeError, match="CUDA device"):
        search.autotune_matmul(64, 256, 128, cache=TuningCache())
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            search.autotune_paged_decode(4, 4, 64, 2, 4, 16, cache=TuningCache())


def test_candidate_lattices_hold_the_rule_and_only_instantiated_geometry():
    for m, k, n in ((16, 2048, 2048), (64, 2048, 92544), (256, 8192, 2048), (4096, 2048, 1024)):
        lat = candidates.matmul_candidates(m, k, n)
        tm, tn, ks = matmul_ops.launch_shape(m, n, k, torch.bfloat16, 132)
        assert lat[0] == (tm, tn, -(-k // ks))
        assert {(bm, bn) for bm, bn, _ in lat} <= set(matmul_ops.TILES)
        assert all(s == 1 or k >= s * matmul_ops.MIN_SPLIT_STEPS * matmul_ops.BLOCK_K
                   for *_, s in lat[1:])
        geos = [(bm, bn, candidates.split_depth(k, s, 64)) for bm, bn, s in lat]
        assert len(set(geos)) == len(geos)
        lat8 = candidates.int8_matmul_candidates(m, k, n)
        tm, tn, ks = quant_ops.launch_shape(m, n, k, 132)
        assert lat8[0] == (tm, tn, -(-k // ks))
        assert {(bm, bn) for bm, bn, _ in lat8} <= {quant_ops.DECODE_TILE, quant_ops.WIDE_TILE}
        assert max(s for *_, s in lat8) <= 8
    assert candidates.matmul_candidates(64, 2048, 2048, 4)[0][:2] == matmul_ops.F32_TILE
    assert candidates.int8_fused_mlp_candidates(256, 2048, 8192) == [(128, 32), (64, 32)]
    paged = candidates.paged_decode_candidates(64, 8, 2, 128, 128)
    assert paged[0] == (32, 1) and len(paged) == len(set(paged))
    for tile, s in candidates.paged_decode_candidates(16, 8, 12, 128, 4096):
        assert tile in flash_ops.PAGED_TILES and 1 <= s <= flash_ops.MAX_SPLITS
    with pytest.raises(ValueError, match="at least one split"):
        candidates.split_depth(2048, 0, 64)


def test_wall_us_on_the_cpu():
    x = torch.ones(8)
    mean, samples = wall_us(lambda t: t * 2, x, iters=4, warmup=1, return_samples=True)
    assert len(samples) == 4 and mean == sum(samples) / 4 and mean > 0
    assert wall_us(lambda t: t + 1, x, iters=3) > 0


def test_the_sweeps_share_the_timer():
    from repro_torch.tuning import int8_tiles, paged_tiles, ssd_bwd_tiles, ssd_tiles
    assert int8_tiles.time_ms is ssd_tiles.time_ms is ssd_bwd_tiles.time_ms is time_ms
    assert paged_tiles._time_ms.func is time_ms
    assert paged_tiles._time_ms.keywords == {"iters": paged_tiles.ITERS, "host": True}
    for mod in (int8_tiles, ssd_bwd_tiles):
        assert not hasattr(mod, "_time_ms") and not hasattr(mod, "SLEEP_CYCLES")


# --- the advisor's bucket growth and the engine's block size ------------------------

def _profile_caches(tmp_path):
    """The same H100 matmul entries at the decode GEMMs of internlm2-1.8b's
    smoke config, in each package's cache."""
    jc, pc = jax_cache.TuningCache(), TuningCache()
    cfg = get_smoke_config(ARCH)
    for m in (8, 16, 64, 128):
        for k, n, us in ((cfg.d_model, cfg.d_model, 3.5), (cfg.d_model, cfg.d_ff, 4.75),
                         (cfg.d_ff, cfg.d_model, 4.0 + m / 64)):
            for mod, c in ((jax_cache, jc), (port_cache, pc)):
                c.put(mod.TunedConfig(op="matmul", shape=(m, k, n), dtype="float32",
                                      hw_name="h100", blocks={"block_m": 64}, time_us=us))
    return jc, pc


@pytest.mark.parametrize("arch,smoke", [(ARCH, True), (ARCH, False), ("gpt3-2.7b-c0", False),
                                        ("qwen1.5-4b", False), ("mamba2-780m", True)])
def test_grow_batch_matches_jax_at_the_h100(arch, smoke, tmp_path):
    jcfg = jax_get_smoke_config(arch) if smoke else jax_get_config(arch)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    jc, pc = _profile_caches(tmp_path)
    profiles = [(None, None), (JaxMeasuredProfile.from_cache(jc, "h100"),
                               MeasuredProfile.from_cache(pc, "h100"))]
    for jprof, prof in profiles:
        for max_batch, max_prompt, max_seq in ((8, 64, 96), (3, 48, 0), (70, 200, 0), (1, 16, 17)):
            want = jax_make_policy(jcfg, JAX_H100, max_batch=max_batch, max_prompt=max_prompt,
                                   max_seq=max_seq, profile=jprof, grow_batch=True)
            got = make_policy(cfg, H100_SXM, max_batch=max_batch, max_prompt=max_prompt,
                              max_seq=max_seq, profile=prof, grow_batch=True)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_get_smoke_config(ARCH)
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config(ARCH)
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


@pytest.mark.parametrize("block_size", [None, 16, 32, 48])
def test_pick_block_size_reads_the_pool_entry_as_jax(smoke, block_size, installed):
    """With a pool entry for the engine's geometry both engines take its
    block size (48 does not divide the pool depth: both fall back); with
    none, both take the lattice fallback."""
    jcfg, jparams, cfg, params = smoke
    kw = dict(max_batch=4, max_prompt=32, max_new=32)
    probe = Engine(params, cfg, prefix_cache=True, device="cpu", **kw)
    n, s_max = probe.policy.num_slots, probe.policy.seq_max
    shape = (n, n, s_max, cfg.num_kv_heads, cfg.num_heads, cfg.head_dim)
    jc = jax_cache.TuningCache()
    if block_size is not None:
        blocks = {"block_size": block_size, "tile": 32, "splits": 1}
        installed.put(_entry("paged_decode_blocktable_pool", shape, "float32", blocks))
        jc.put(jax_cache.TunedConfig(op="paged_decode_blocktable_pool", shape=shape,
                                     dtype="float32", hw_name="h100",
                                     blocks={"block_size": block_size, "block_kv": 32},
                                     time_us=1.0))
    jax_cache.set_default_cache(jc)
    try:
        want = JaxEngine(jparams, jcfg, prefix_cache=True, hw=JAX_H100, **kw).pool.block_size
    finally:
        jax_cache.set_default_cache(None)
    got = Engine(params, cfg, prefix_cache=True, device="cpu", **kw).pool.block_size
    assert got == want
    assert got == (block_size if block_size in (16, 32) else
                   candidates.fallback_block_size(s_max, 64))


# --- the dispatch layer and the launchers -------------------------------------------

@pytest.mark.parametrize("impl,tuned", [("pallas", False), ("tuned", True), ("fused", True),
                                        ("quantized", True)])
def test_linear_impls_pass_tuned_as_jax(impl, tuned, monkeypatch):
    """As JAX's `_LinearConfig`: "tuned", "fused" and "quantized" look the
    cache up, "pallas" does not (forward, dgrad, wgrad and the fused MLP)."""
    from repro_torch.models import linear as linear_mod
    seen = []

    def spy(real):
        def f(*a, **kw):
            seen.append(kw.get("tuned"))
            return real(*a, **kw)
        return f
    for name in ("matmul", "int8_matmul", "fused_mlp_hidden", "int8_fused_mlp_hidden"):
        monkeypatch.setattr(linear_mod, name, spy(getattr(linear_mod, name)))
    cfg = dataclasses.replace(get_smoke_config(ARCH), linear_impl=impl)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, cfg.d_model, generator=gen, requires_grad=True)
    w = torch.randn(cfg.d_model, 24, generator=gen, requires_grad=True)
    linear_mod.linear(x, w, impl=impl).sum().backward()
    with torch.no_grad():
        linear_mod.linear(x, w, impl=impl)
    if impl in ("fused", "quantized"):
        p = {k: torch.randn(*s, generator=gen) for k, s in (
            ("w_gate", (cfg.d_model, cfg.d_ff)), ("w_up", (cfg.d_model, cfg.d_ff)),
            ("w_down", (cfg.d_ff, cfg.d_model)))}
        with torch.no_grad():
            (linear_mod.fused_mlp if impl == "fused" else linear_mod.quantized_mlp)(x, p, cfg)
    assert len(seen) >= 4 and set(seen) == {tuned}


def test_train_launcher_prints_jax_advisor_lines(capsys, tmp_path):
    """gpt3-smoke's findings on the H100, in JAX's launcher's format."""
    from repro_torch.launch import train
    train.main(["--arch", "gpt3-2.7b-c0", "--smoke", "--steps", "1", "--global-batch", "2",
                "--seq-len", "16", "--device", "cpu", "--checkpoint-dir", str(tmp_path)])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[advisor:")]
    jcfg = jax_get_smoke_config("gpt3-2.7b-c0")
    want = [f"[advisor:{f.severity}] {f.rule}: {f.message}"
            for f in jax_advisor.check_alignment(jcfg, JAX_H100, tp=1, global_batch=2)
            if f.severity != "ok"]
    assert lines == want and len(want) >= 3


def test_serve_launcher_grows_the_bucket(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--smoke", "--engine", "--grow-batch", "--device", "cpu",
                "--requests", "2", "--gen", "2", "--batch", "2", "--prompt-len", "8"])
    out = capsys.readouterr().out
    jcfg = jax_get_smoke_config(ARCH)
    want = jax_make_policy(jcfg, JAX_H100, max_batch=2, max_prompt=8, max_seq=10,
                           grow_batch=True)
    assert f"bucket policy: {want.num_slots} slots x {want.seq_max} kv depth" in out
