"""The port's checkpointer (`repro_torch.checkpoint`) and the train
launcher's `--checkpoint-every` / `--resume`, against the JAX package's
`repro.checkpoint` on internlm2-smoke.

The on-disk layout is JAX's, so a checkpoint written by either package
restores in the other, leaf for leaf and bit for bit.  The JAX suite's
checkpointer cases (`tests/test_checkpoint_data.py`) run on the port.  The
port labels a checkpoint by the number of updates applied; a test shows the
JAX launcher's mid-run label, one short of its `OptState.step`.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import Checkpointer as JaxCheckpointer
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.models import init_lm as jax_init_lm
from repro.optim.adamw import init_opt as jax_init_opt
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw
from repro_torch.optim.adamw import OptState, init_opt, tree_leaves
from repro_torch.train.train_step import make_train_step

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCH = "internlm2-1.8b"
TRAIN = ["--arch", ARCH, "--smoke", "--device", "cpu", "--global-batch", "2", "--seq-len", "16",
         "--log-every", "1"]


@pytest.fixture(scope="module")
def ref():
    jcfg = jax_get_smoke_config(ARCH)
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, get_smoke_config(ARCH)


def _port(ref, optimizer="adamw", dtype=torch.float32):
    """The JAX params through the bridge: float32 masters, or (dtype None)
    a bfloat16 config's serving params, GEMM weights cast to bfloat16."""
    _, jparams, cfg = ref
    if dtype is None:
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu", dtype=dtype)
    return cfg, params, init_opt(params, TrainConfig(optimizer=optimizer))


def _leaves(tree):
    return list(tree_leaves(tree, adamw._is_quant)) if not isinstance(tree, OptState) else \
        [tree.step, *_qleaves(tree.m), *_qleaves(tree.v)]


def _qleaves(tree):
    out = []
    for leaf in tree_leaves(tree, adamw._is_quant):
        out += [leaf["codes"], leaf["scale"]] if adamw._is_quant(leaf) else [leaf]
    return out


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


# --- the JAX suite's checkpointer cases, on the port ----------------------------------------

class TestCheckpointer:
    @pytest.mark.parametrize("optimizer", ["adamw", "adamw8bit"])
    def test_roundtrip_exact(self, ref, tmp_path, optimizer):
        cfg, params, opt = _port(ref, optimizer)
        step_fn = make_train_step(cfg, TrainConfig(total_steps=2, warmup_steps=1,
                                                   optimizer=optimizer))
        batch = {k: torch.from_numpy(v)
                 for k, v in make_batch(cfg, ShapeConfig("t", 16, 2, "train"), 0, 0).items()}
        params, opt, _ = step_fn(params, opt, batch)     # moments and step not zero
        ck = Checkpointer(str(tmp_path), keep=2)
        ck.save(3, params, opt)
        _, params2, opt2 = _port(ref, optimizer)
        p2, o2, step = ck.restore(params2, opt2)
        assert step == 3
        _assert_same(params, p2)
        _assert_same(opt, o2)
        assert int(o2.step) == 1

    def test_rotation_keeps_newest(self, ref, tmp_path):
        _, params, _ = _port(ref)
        ck = Checkpointer(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            ck.save(s, params)
        assert ck.all_steps() == [3, 4]

    def test_async_save(self, ref, tmp_path):
        _, params, opt = _port(ref)
        ck = Checkpointer(str(tmp_path), keep=2)
        ck.save(7, params, opt, blocking=False)
        ck.wait()
        assert ck.latest_step() == 7

    def test_restore_missing_raises(self, ref, tmp_path):
        _, params, _ = _port(ref)
        with pytest.raises(FileNotFoundError):
            Checkpointer(str(tmp_path)).restore(params)

    def test_atomicity_no_partial_dirs(self, ref, tmp_path):
        _, params, _ = _port(ref)
        Checkpointer(str(tmp_path)).save(1, params)
        assert not [x for x in os.listdir(tmp_path) if x.startswith(".tmp")]


# --- across the packages ------------------------------------------------------------------

@pytest.mark.parametrize("optimizer", ["adamw", "adamw8bit"])
def test_jax_checkpoint_restores_in_the_port(ref, tmp_path, optimizer):
    """JAX writes params and optimizer state; the port restores them into
    its templates equal to `params_from_jax`'s tensors bit for bit (float32
    masters, and bfloat16 weights, cast as the bridge casts them)."""
    jcfg, jparams, cfg = ref
    jopt = jax_init_opt(jparams, JaxTrainConfig(optimizer=optimizer))
    jopt = type(jopt)(jnp.asarray(5, jnp.int32), jopt.m, jopt.v)
    JaxCheckpointer(str(tmp_path)).save(5, jparams, jopt, meta={"arch": jcfg.name})
    for dtype in (torch.float32, None):
        _, params, opt = _port(ref, optimizer, dtype)
        got, got_opt, step = Checkpointer(str(tmp_path)).restore(_zeros(params),
                                                                 _zeros_opt(opt))
        assert step == 5 and int(got_opt.step) == 5
        _assert_same(params, got)
        want_opt = OptState(torch.tensor(5, dtype=torch.int32), opt.m, opt.v)
        _assert_same(want_opt, got_opt)


def _zeros(tree):
    return adamw.tree_map(torch.zeros_like, tree)


def _zeros_opt(opt):
    return OptState(torch.zeros_like(opt.step), _zeros(opt.m), _zeros(opt.v))


@pytest.mark.parametrize("optimizer", ["adamw", "adamw8bit"])
def test_port_checkpoint_restores_in_jax(ref, tmp_path, optimizer):
    """The reverse: the port writes after one AdamW step (its keys, its
    dtypes), JAX restores every leaf into its own templates, equal to the
    port's tensors bit for bit."""
    jcfg, jparams, _ = ref
    cfg, params, opt = _port(ref, optimizer)
    step_fn = make_train_step(cfg, TrainConfig(total_steps=2, warmup_steps=1,
                                               optimizer=optimizer))
    batch = {k: torch.from_numpy(v)
             for k, v in make_batch(cfg, ShapeConfig("t", 16, 2, "train"), 0, 0).items()}
    params, opt, _ = step_fn(params, opt, batch)
    Checkpointer(str(tmp_path)).save(1, params, opt)
    manifest = json.loads((tmp_path / "step_1" / "manifest.json").read_text())
    assert "opt/.step" in manifest["leaves"] and "params/seg0/attn/wq" in manifest["leaves"]
    jopt = jax_init_opt(jparams, JaxTrainConfig(optimizer=optimizer))
    p_np, o_np, step = JaxCheckpointer(str(tmp_path)).restore(jparams, jopt)
    assert step == 1 and int(o_np.step) == 1
    want = {f"params/{k}": v for k, v in _paths(params)}
    want.update({f"opt/.m/{k}": v for k, v in _paths(opt.m)})
    want.update({f"opt/.v/{k}": v for k, v in _paths(opt.v)})
    got = {"params/" + "/".join(str(getattr(k, "key", k)) for k in path): leaf
           for path, leaf in jax.tree_util.tree_flatten_with_path(p_np)[0]}
    for field, tree in ((".m", o_np.m), (".v", o_np.v)):
        got.update({f"opt/{field}/" + "/".join(str(getattr(k, "key", k)) for k in path): leaf
                    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]})
    assert got.keys() == want.keys()
    for k, t in want.items():
        np.testing.assert_array_equal(got[k], t.detach().numpy(), err_msg=k)
        assert got[k].dtype == t.detach().numpy().dtype, k


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def test_bf16_leaves_round_trip_as_raw_fields(ref, tmp_path):
    """bfloat16 leaves go to disk as 2-byte fields (|V2, what numpy writes
    for JAX's bfloat16) and come back bit for bit."""
    _, params, _ = _port(ref, dtype=None)
    assert params["seg0"]["attn"]["wq"].dtype == torch.bfloat16
    ck = Checkpointer(str(tmp_path))
    ck.save(2, params)
    with np.load(tmp_path / "step_2" / "leaves.npz") as z:
        assert z["params/seg0/attn/wq"].dtype == np.dtype("V2")
        assert z["params/final_norm/scale"].dtype == np.float32
    got, _, _ = ck.restore(_zeros(params))
    _assert_same(params, got)


def test_async_save_snapshots_before_the_next_in_place_step(ref, tmp_path):
    """The optimizer updates in place; an async save followed at once by a
    step must still restore the values at the save."""
    cfg, params, opt = _port(ref)
    tc = TrainConfig(total_steps=3, warmup_steps=1)
    step_fn = make_train_step(cfg, tc)
    batches = [{k: torch.from_numpy(v)
                for k, v in make_batch(cfg, ShapeConfig("t", 16, 2, "train"), s, 0).items()}
               for s in range(2)]
    params, opt, _ = step_fn(params, opt, batches[0])
    saved = [t.detach().clone() for t in _leaves(params) + _leaves(opt)]
    ck = Checkpointer(str(tmp_path))
    ck.save(1, params, opt, blocking=False)
    params, opt, _ = step_fn(params, opt, batches[1])     # overwrites the leaves in place
    ck.wait()
    assert not torch.equal(saved[0], _leaves(params)[0])
    p2, o2, _ = ck.restore(_zeros(params), _zeros_opt(opt))
    for a, b in zip(saved, _leaves(p2) + _leaves(o2)):
        assert torch.equal(a, b)


# --- the train launcher ----------------------------------------------------------------------

def _final(d, step):
    with np.load(os.path.join(d, f"step_{step}", "leaves.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("optimizer", ["adamw", "adamw8bit"])
def test_resumed_run_equals_the_uninterrupted_one(tmp_path, capsys, optimizer):
    """4 steps with a checkpoint every 2 updates; a second run restarted
    from `step_2` of the same schedule (its `step_4` removed) follows the
    uninterrupted trajectory: the same losses at steps 2-3 and a final
    checkpoint equal leaf for leaf."""
    from repro_torch.launch import train
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    argv = TRAIN + ["--steps", "4", "--checkpoint-every", "2", "--optimizer", optimizer]
    train.main(argv + ["--checkpoint-dir", a])
    full = capsys.readouterr().out
    assert sorted(os.listdir(a)) == ["step_2", "step_4"]
    for step in (2, 4):     # a label is the number of updates applied
        assert int(_final(a, step)["opt/.step"]) == step
    shutil.copytree(os.path.join(a, "step_2"), os.path.join(b, "step_2"))
    train.main(argv + ["--checkpoint-dir", b, "--resume"])
    resumed = capsys.readouterr().out
    assert "resumed from step 2" in resumed
    losses = [line for line in full.splitlines() if line.startswith("step ")]
    assert [line.split("tok/s")[0] for line in losses[2:]] == \
        [line.split("tok/s")[0] for line in resumed.splitlines() if line.startswith("step ")]
    want, got = _final(a, 4), _final(b, 4)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].shape == want[k].shape, k


def test_launcher_default_checkpoint_dir_is_under_tmpdir(tmp_path):
    """With no --checkpoint-dir the launcher's final checkpoint goes to
    repro_ckpt under $TMPDIR (the JAX package's /tmp/repro_ckpt where
    TMPDIR is unset), not to a path that runs of other checkouts share."""
    env = dict(os.environ, TMPDIR=str(tmp_path),
               PYTHONPATH=os.pathsep.join(p for p in (SRC, os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *TRAIN, "--steps", "1",
                          "--checkpoint-every", "0"],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert sorted(os.listdir(tmp_path / "repro_ckpt")) == ["step_1"]
    assert int(_final(tmp_path / "repro_ckpt", 1)["opt/.step"]) == 1


def test_jax_launcher_labels_a_midrun_checkpoint_one_short(tmp_path):
    """The reference fault the port does not copy: JAX saves after applying
    step s's update and labels it `step_s`, so its `OptState.step` is s + 1
    (and `--resume` would apply batch s twice).  The final checkpoint is
    labelled right."""
    from repro.launch import train as jax_train
    jax_train.main(["--arch", ARCH, "--smoke", "--steps", "2", "--global-batch", "1",
                    "--seq-len", "8", "--checkpoint-every", "1", "--checkpoint-dir",
                    str(tmp_path), "--log-every", "5"])
    mid, final = _final(tmp_path, 1), _final(tmp_path, 2)
    assert json.loads((tmp_path / "step_1" / "manifest.json").read_text())["step"] == 1
    assert int(mid["opt/.step"]) == 2
    assert int(final["opt/.step"]) == 2
