"""Checkpointing of the port: atomic save / restore / rotation, on the JAX
package's on-disk layout.

A checkpoint is a directory `step_<n>` holding `leaves.npz` (every leaf of
{"params": params, "opt": opt_state} as a numpy array, keyed by the JAX
package's path strings) and `manifest.json` (step, time, the sorted leaf
keys, caller metadata).  The keys are JAX's `tree_flatten_with_path`
spelling: dict keys joined by "/", and an `OptState` field as ".step",
".m", ".v" (a NamedTuple field prints with its dot), so a params leaf is
`params/seg0/attn/wq` and a moment `opt/.m/seg0/attn/wq`, or
`opt/.m/seg0/attn/wq/codes` and `.../scale` under adamw8bit.  A checkpoint
written by either package restores in the other.

  * `save` snapshots every leaf into host memory before it returns (a copy:
    the optimizer updates params and moments in place, and on the host
    `Tensor.numpy()` would share their memory), then writes in a temporary
    directory renamed into place, on a worker thread when `blocking=False`;
    the manifest is written last, so a half-written checkpoint is never
    listed.  bfloat16 leaves are stored as raw 2-byte fields (`|V2`, what
    numpy writes for JAX's bfloat16 arrays).
  * `restore` returns torch trees shaped like the templates, each leaf on
    its template's device and in its dtype (a `|V2` or bfloat16 field is
    read as bfloat16, a float32 one cast to a bfloat16 template).
  * rotation keeps the newest `keep` checkpoints.

Elastic restore, as JAX's launcher does it (`repro/launch/train.py`: the
mesh is rebuilt from the current world and restore reshards the leaves
onto it).  Under a sharding plan (`parallel/sharding.py`) the trees hold
this rank's blocks: `save(..., plan=)` gathers every leaf whole to rank 0,
leaf by leaf (a collective: every rank calls it; of a KV block replicated
over `model`, one replica), and rank 0 writes the same format, so a
checkpoint written on one mesh, or by either package, restores on any;
`restore(..., plan=)` reads the whole leaves and keeps this rank's block
of each, by the spec tree of the mesh it runs on.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..optim.adamw import OptState, tree_map
from ..parallel.sharding import gather_leaf_to_host, local_shard

_BF16_FIELD = np.dtype("V2")


def _flatten(tree: Any, prefix: str = "", specs: Any = None, plan=None) -> Dict[str, np.ndarray]:
    """{JAX path string: host copy} for every tensor leaf of `tree`; under a
    sharding plan each leaf is gathered whole in turn (a collective) and
    only the mesh's rank 0 keeps host copies."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, OptState):
        for field in OptState._fields:
            out.update(_flatten(getattr(tree, field), f"{prefix}.{field}/",
                                None if specs is None else getattr(specs, field), plan))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/", None if specs is None else specs[k],
                                plan))
    elif plan is None:
        out[prefix[:-1]] = _host_copy(tree)
    else:
        whole = gather_leaf_to_host(tree, specs, plan.mesh, plan.rep_of(prefix.split("/")))
        if whole is not None:
            out[prefix[:-1]] = _host_copy(whole)
    return out


def _host_copy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_FIELD)
    return t.numpy()


def _as_template(key: str, arr, like: Optional[torch.Tensor]) -> torch.Tensor:
    """`arr` (numpy, or a torch block already) as a tensor like `like`; no
    template: the whole leaf as a host tensor."""
    if torch.is_tensor(arr):
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {key}: block {tuple(arr.shape)}, expected "
                             f"{tuple(like.shape)}")
        return arr.to(device=like.device, dtype=like.dtype, copy=True)
    if like is not None and tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {key}: shape {arr.shape}, expected {tuple(like.shape)}")
    if arr.dtype.itemsize == 2 and arr.dtype.kind not in "iuf":
        # a bfloat16 field: |V2 without ml_dtypes, ml_dtypes' bfloat16 with it
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr if arr.flags.writeable else np.array(arr))
    if like is None:
        return t
    return t.to(device=like.device, dtype=like.dtype, copy=True)


def _unflatten_into(template: Any, flat: Dict[str, np.ndarray], prefix: str = "",
                    specs: Any = None, mesh=None, rep_of=None) -> Any:
    """`rep_of(path)`: a leaf's KV replication over `model` (`Plan.rep_of`)."""
    if isinstance(template, OptState):
        return OptState(*(_unflatten_into(getattr(template, f), flat, f"{prefix}.{f}/",
                                          None if specs is None else getattr(specs, f), mesh,
                                          rep_of)
                          for f in OptState._fields))
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/", None if specs is None else specs[k],
                                   mesh, rep_of)
                for k, v in template.items()}
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"checkpoint has no leaf {key!r}")
    arr = flat[key]
    if specs is not None:
        arr = local_shard(_as_template(key, arr, None), specs, mesh,
                          rep_of(key.split("/")) if rep_of else 1)
    return _as_template(key, arr, template)


def _is_quant(x) -> bool:
    return isinstance(x, dict) and "codes" in x


def state_specs(plan, params, opt_state=None):
    """Spec trees of {params, opt}: the moments as their parameters, an
    int8 moment's scale whole along the last dim, the step replicated."""
    pspecs = plan.specs(params)
    if opt_state is None:
        return pspecs, None

    def moment(t, s):
        return {"codes": s, "scale": (*s[:-1], None)} if _is_quant(t) else s
    return pspecs, OptState((), tree_map(moment, opt_state.m, pspecs, is_leaf=_is_quant),
                            tree_map(moment, opt_state.v, pspecs, is_leaf=_is_quant))





class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # --- save -------------------------------------------------------------
    def save(self, step: int, params: Any, opt_state: Any = None,
             meta: Optional[dict] = None, blocking: bool = True, plan=None):
        """Write checkpoint `step`; the leaves are copied to host memory
        before this returns, so the caller may update them at once.  Under
        a sharding plan every rank calls it, the leaves are gathered whole
        and rank 0 writes them (a blocking save returns on every rank once
        the checkpoint is in place)."""
        tree = {"params": params}
        if opt_state is not None:
            tree["opt"] = opt_state
        specs = None
        if plan is not None:
            pspecs, ospecs = state_specs(plan, params, opt_state)
            specs = {"params": pspecs, "opt": ospecs}
        flat = _flatten(tree, specs=specs, plan=plan)
        if plan is not None and plan.mesh.rank != 0:
            if blocking:
                plan.mesh.barrier()
            return
        self.wait()  # never two writers

        def write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "leaves.npz"), **flat)
            manifest = {"step": step, "time": time.time(),
                        "leaves": sorted(flat), **(meta or {})}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._rotate()

        if blocking:
            write()
            if plan is not None:
                plan.mesh.barrier()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _rotate(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # --- restore ----------------------------------------------------------
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, d, "manifest.json")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, params_template: Any, opt_template: Any = None,
                step: Optional[int] = None, plan=None) -> Tuple[Any, Any, int]:
        """Returns (params, opt_state, step): torch trees shaped like the
        templates, each leaf on its template's device in its dtype.  Under
        a sharding plan the templates are this rank's blocks on the
        plan's mesh, and each leaf is resharded onto it."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        pspecs = ospecs = mesh = rep_of = None
        if plan is not None:
            pspecs, ospecs = state_specs(plan, params_template, opt_template)
            mesh, rep_of = plan.mesh, plan.rep_of
        # leaf by leaf from the archive: a rank holds one whole leaf at a time
        with np.load(os.path.join(path, "leaves.npz")) as flat:
            params = _unflatten_into(params_template, flat, "params/", pspecs, mesh, rep_of)
            opt = None
            if opt_template is not None:
                opt = _unflatten_into(opt_template, flat, "opt/", ospecs, mesh, rep_of)
        return params, opt, step
