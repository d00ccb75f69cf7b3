"""Rank programs for tests/test_torch_parallel*.py (not a test module).

    python tests/torch_parallel_cases.py DIR

reads DIR/suite.json, a list of case jobs, spawns one world of ranks on the
host over gloo (`repro_torch.launch.mesh.spawn`), and runs the cases in
order, each on a mesh over the first ranks of the world.  A case reads its
job's "dir" (params.npz: the JAX package's params flattened by "/" path;
inputs.npz for the pipeline) and its mesh's rank 0 writes out.npz there.
Each case runs sound first, then once for each planted fault of
job["faults"] (`planted`), under "<fault>/" keys.  Imports torch and the
port only: the JAX side is the tests'.  `run_suite` (or `start_suite`, then
`finish_suite`) is the tests' entry.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.checkpoint.ckpt import Checkpointer, state_specs  # noqa: E402
from repro_torch.configs.base import MeshConfig, ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import blocks as blocks_mod  # noqa: E402
from repro_torch.models import lm as lm_mod  # noqa: E402
from repro_torch.models import lm_loss, moe, moe_shardmap  # noqa: E402
from repro_torch.models import linear as linear_mod  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.linear import quantize_linear_params  # noqa: E402
from repro_torch.optim.adamw import OptState, init_opt, tree_leaves  # noqa: E402
from repro_torch.parallel import audit, comm, pipeline  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.serving.serve_step import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.train import train_step as train_step_mod  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402


# --- planted faults -------------------------------------------------------------------

def _local_sq_sum(self, tree, specs):
    return sum(torch.sum(torch.square(t.float())) for t in tree_leaves(tree))


def _local_reduce_scatter(t, group, dim, kind=None):
    return t.chunk(comm.size(group), dim=dim)[comm.rank(group)].contiguous()


_STEP = [0]      # the train case's step, for faults that start late
_row_absmax = sh.Plan.row_absmax
_reduce_grads = sh.Plan.reduce_grads


def _kv_grads_unsummed(self, grads, specs):
    """reduce_grads with each replicated KV block's gradient left as this
    rank's partial (no sum over the ranks that hold the KV head)."""
    kv_group, self.kv_group = self.kv_group, None
    try:
        return _reduce_grads(self, grads, specs)
    finally:
        self.kv_group = kv_group
_apply_encoder = lm_mod.apply_encoder


def _encoder_without_allreduce(*args, **kwargs):
    """apply_encoder with its row-parallel all-reduces (wo, w_down) skipped."""
    real = sh.reduce_from_tp
    sh.reduce_from_tp = lambda x: x
    try:
        return _apply_encoder(*args, **kwargs)
    finally:
        sh.reduce_from_tp = real


FAULTS = {
    # every all-reduce after a row-parallel layer (and the embedding's) dropped
    "dropped_allreduce": [(sh, "reduce_from_tp", lambda x: x)],
    # gradients left per data rank: no all-reduce, no reduce-scatter sum
    "no_data_average": [(sh.Plan, "reduce_grads", lambda self, g, s: g),
                        (comm, "reduce_scatter", _local_reduce_scatter)],
    # the clip norm of this rank's blocks only
    "local_clip_norm": [(sh.Plan, "global_sq_sum", _local_sq_sum)],
    # adamw8bit's absmax over this rank's part of a row
    "local_absmax": [(sh.Plan, "row_absmax", lambda self, a, spec: a)],
    # the same from the second step on (a fault in the moments of step 2)
    "late_local_absmax": [(sh.Plan, "row_absmax", lambda self, a, spec:
                           a if _STEP[0] > 0 else _row_absmax(self, a, spec))],
    # MoE "auto" packing only this rank's tokens: local capacity and slots
    "local_capacity": [(moe, "global_slots", lambda counts, t: (torch.zeros_like(counts), t))],
    # shard_map with the global capacity and slots of "auto"
    "shardmap_global": [(moe_shardmap, "apply_moe_shardmap", moe.apply_moe_auto)],
    # MLA: each rank's slice of the down projections' latents in place of
    # the gathered latent (repeated to its width)
    "latent_slice": [(sh, "gather_latent",
                      lambda x, dim=-1: torch.cat([x] * sh.tp_size(), dim=dim))],
    # the SSD gated norm's mean square over this rank's columns only
    "norm_sum_dropped": [(sh, "sum_over_tp", lambda x: x)],
    # sequence parallelism: each row-parallel exit keeps this rank's slice
    # of its own partial sums, never summed over `model`
    "seq_local_slice": [(sh, "seq_reduce_scatter",
                         lambda x: x.chunk(sh.tp_size(), dim=1)[sh.tp_rank()].contiguous())],
    # the encoder's row-parallel all-reduces dropped (the decoder's kept)
    "encoder_allreduce_dropped": [(lm_mod, "apply_encoder", _encoder_without_allreduce)],
    # sequence parallelism: the norm gains' gradients left as each rank's
    # partial over its sequence shard, never summed over `model`
    "seq_norm_sum_dropped": [(blocks_mod, "_norms_summed_over_tp", lambda p: p)],
    # KV heads replicated over `model`: the replicas' wk / wv gradients not summed
    "kv_grads_unsummed": [(sh.Plan, "reduce_grads", _kv_grads_unsummed)],
    # halo heads: the gather's backward keeps each rank's own partial gradient
    "halo_grad_unsummed": [(sh, "gather_heads", audit.halo_grad_unsummed)],
    # halo heads: each rank gathers its neighbour's head in place of its own
    "neighbour_head": [(sh, "gather_heads", audit.neighbour_head)],
    # int8 under tensor parallelism: a row-parallel activation's absmax over
    # this rank's columns only (no MAX over `model`)
    "act_scale_unreduced": [(linear_mod, "row_activation_absmax",
                             audit.activation_absmax_unreduced)],
    # ... a per-call weight's column absmax over this rank's rows only
    "weight_scale_unreduced": [(linear_mod, "row_weight_absmax", audit.weight_absmax_unreduced)],
    # ... the codes taken at the shard's own absmax, the scale the MAX over `model`
    "codes_at_shard_absmax": [(linear_mod, "quantize_int8", audit.codes_at_shard_absmax)],
}


@contextlib.contextmanager
def planted(fault):
    saved = []
    for owner, name, fn in FAULTS.get(fault, ()):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, fn)
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


# --- helpers ----------------------------------------------------------------------------

def _nest(flat):
    out = {}
    for path, arr in flat.items():
        node = out
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = arr
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree.detach().float().numpy().copy()}


def gather_state(plan, params, opt):
    """(params, opt) gathered whole from the ranks' blocks."""
    pspecs, ospecs = state_specs(plan, params, opt)
    return plan.gather(params, pspecs), OptState(
        opt.step, plan.gather(opt.m, ospecs.m), plan.gather(opt.v, ospecs.v))


def _flat_state(params, opt):
    return {**_flat(params, "params/"), **_flat(opt.m, "m/"), **_flat(opt.v, "v/")}


def _cfg(job):
    return dataclasses.replace(get_smoke_config(job["arch"]), **job.get("cfg", {}))


def _whole_params(d, cfg, job=None):
    d = (job or {}).get("params", d)
    with np.load(os.path.join(d, "params.npz")) as z:
        flat = {k: z[k] for k in z.files}
    return params_from_jax(_nest(flat), cfg, "cpu", dtype=torch.float32)




def _tc(job):
    return TrainConfig(total_steps=job["total_steps"], warmup_steps=1,
                       optimizer=job.get("optimizer", "adamw"), grad_clip=job["grad_clip"],
                       remat=job.get("remat", "none"), seed=0)


@contextlib.contextmanager
def counting_gathers(counter):
    """Count the FSDP all-gathers (`comm.fsdp_gather` calls) into counter[0]."""
    real = comm.fsdp_gather

    def f(x, group, dim):
        counter[0] += 1
        return real(x, group, dim)
    comm.fsdp_gather = f
    try:
        yield
    finally:
        comm.fsdp_gather = real


def _fsdp_leaves(plan, params):
    """(data-sharded leaves a forward gathers once each, layer leaves
    gathered once a layer): the embedding and head; every layer's."""
    specs = plan.specs(params)
    top = layer = 0
    for key, sub in specs.items():
        for path, spec in sh._paths(sub):
            if "data" not in spec:
                continue
            if key.startswith("seg"):
                layer += _at_path(params[key], path).shape[0]
            else:
                top += 1
    return top, layer


def _at_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _shape(job):
    return ShapeConfig("t", job["seq"], job["batch"], "train")


def _batch(cfg, job, step):
    return {k: torch.from_numpy(v) for k, v in make_batch(cfg, _shape(job), step, 0).items()}


# --- cases ------------------------------------------------------------------------------

@contextlib.contextmanager
def recording_grads(plan, record):
    """The train step's reduced gradients of its first update, gathered
    whole, into record (read where `apply_updates` takes them)."""
    real = train_step_mod.apply_updates

    def f(params, grads, opt_state, tc, plan=None, specs=None):
        if not record:
            record.update(_flat(plan.gather(grads, specs), "grads/"))
        return real(params, grads, opt_state, tc, plan=plan, specs=specs)
    train_step_mod.apply_updates = f
    try:
        yield
    finally:
        train_step_mod.apply_updates = real


def train_case(mesh, d, job):
    """Steps at a (data, model) mesh from the JAX params: each step's loss
    and grad norm, params and moments gathered after each step (step{i}/)
    and at the end, and with job["grads"] step 0's gradients (grads/); the
    sound run saves a checkpoint (ckpt/) with the plan."""
    cfg = _cfg(job)
    plan = sh.Plan(cfg, mesh)
    whole = _whole_params(d, cfg, job)
    tc = _tc(job)
    out = {}
    for fault in [None] + job.get("faults", []):
        with planted(fault):
            params = plan.shard(whole)
            opt = init_opt(params, tc)
            step_fn = make_train_step(cfg, tc, n_micro=job.get("n_micro", 1), plan=plan)
            losses, norms, steps, gathers, grads = [], [], {}, [0], {}
            for i in range(job["steps"]):
                _STEP[0] = i
                with counting_gathers(gathers), (recording_grads(plan, grads) if job.get("grads")
                                                 else contextlib.nullcontext()):
                    params, opt, m = step_fn(params, opt, _batch(cfg, job, i))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                steps.update({f"step{i}/{k}": v for k, v in
                              _flat_state(*gather_state(plan, params, opt)).items()})
            gathered, state = gather_state(plan, params, opt)
        key = "" if fault is None else f"{fault}/"
        out.update({key + k: v for k, v in {**steps, **grads}.items()})
        out[key + "loss"] = np.array(losses)
        out[key + "grad_norm"] = np.array(norms)
        out[key + "fsdp_gathers"] = np.array(gathers[0])
        out[key + "fsdp_leaves"] = np.array(_fsdp_leaves(plan, params))
        out.update({key + k: v for k, v in _flat_state(gathered, state).items()})
        if fault is None and job.get("checkpoint"):
            Checkpointer(os.path.join(d, "ckpt")).save(job["steps"], params, opt, plan=plan)
    if mesh.rank == 0:
        np.savez(os.path.join(d, "out.npz"), **out)


def restore_case(mesh, d, job):
    """Restore the checkpoint in job["ckpt"] onto this mesh, gather it
    whole, and take one step at the next batch."""
    cfg = _cfg(job)
    plan = sh.Plan(cfg, mesh)
    tc = _tc(job)
    template = plan.shard(init_lm_f32(cfg))
    params, opt, step = Checkpointer(job["ckpt"]).restore(
        template, init_opt(template, tc), plan=plan)
    out = {"step": np.array(step), "opt_step": np.array(int(opt.step))}
    out.update({f"restored/{k}": v for k, v in _flat(plan.gather(params)).items()})
    params, opt, m = make_train_step(cfg, tc, plan=plan)(params, opt, _batch(cfg, job, step))
    out["loss"] = np.array([float(m["loss"])])
    out.update({f"params/{k}": v for k, v in _flat(plan.gather(params)).items()})
    if mesh.rank == 0:
        np.savez(os.path.join(d, "out.npz"), **out)


def init_lm_f32(cfg):
    from repro_torch.models import init_lm
    return init_lm(torch.Generator().manual_seed(1), cfg, device="cpu", dtype=torch.float32)


def grads_case(mesh, d, job):
    """lm_loss and every gradient leaf (gathered whole) at a mesh, on the
    global batch: the train step's path without the update."""
    cfg = _cfg(job)
    plan = sh.Plan(cfg, mesh)
    whole = _whole_params(d, cfg, job)
    out = {}
    batch = _batch(cfg, job, 0)
    for fault in [None] + job.get("faults", []):
        with planted(fault), sh.use(plan):
            params = plan.shard(whole)
            specs = plan.specs(params)
            leaves = list(tree_leaves(params))
            for p in leaves:
                p.requires_grad_(True)
            loss, metrics = lm_loss(params, plan.batch_rows(batch), cfg)
            grads = torch.autograd.grad(loss, leaves)
            it = iter(grads)
            grads = plan.reduce_grads(_tree_like(params, it), specs)
            gathered = plan.gather(grads, specs)
        key = "" if fault is None else f"{fault}/"
        out.update({key + k: np.array(float(v)) for k, v in metrics.items()})
        out.update({f"{key}grads/{k}": v for k, v in _flat(gathered).items()})
    if mesh.rank == 0:
        np.savez(os.path.join(d, "out.npz"), **out)


def _tree_like(tree, it):
    if isinstance(tree, dict):
        return {k: _tree_like(v, it) for k, v in tree.items()}
    return next(it)


def serve_case(mesh, d, job):
    """Prefill and job["decode"] greedy decode steps under tensor
    parallelism: every step's logits and the greedy tokens.  inputs.npz
    (where given) holds the tokens and the model's patch_embeds or
    encoder_frames (an encoder-decoder's output then computed once, under
    the plan, for the decode steps); else tokens.npy."""
    cfg = _cfg(job)
    plan = sh.Plan(cfg, mesh)
    with np.load(os.path.join(job.get("params", d), "params.npz")) as z:
        whole = params_from_jax(_nest({k: z[k] for k in z.files}), cfg, "cpu")
    if job.get("prequantized"):
        whole = quantize_linear_params(whole)
    if os.path.exists(os.path.join(d, "inputs.npz")):
        with np.load(os.path.join(d, "inputs.npz")) as z:
            inputs = {k: torch.from_numpy(z[k]) for k in z.files}
    else:
        inputs = {"tokens": torch.from_numpy(np.load(os.path.join(d, "tokens.npy")))}
    tokens = inputs["tokens"]
    lead = inputs["patch_embeds"].shape[1] if "patch_embeds" in inputs else 0
    out = {}
    for fault in [None] + job.get("faults", []):
        with planted(fault), torch.no_grad(), (audit.row_codes(keep=None) if job.get("codes")
                                               else contextlib.nullcontext()) as codes:
            params = plan.shard(whole)
            s0 = lead + tokens.shape[1]
            logits, caches = make_prefill_step(cfg, s0 + job["decode"], plan)(params, inputs)
            enc_out = None
            if "encoder_frames" in inputs:
                with sh.use(plan):
                    enc_out = lm_mod.apply_encoder(params, inputs["encoder_frames"], cfg)
            steps, toks = [logits], []
            decode = make_decode_step(cfg, plan)
            for i in range(job["decode"]):
                tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
                toks.append(tok)
                logits, caches = decode(params, tok, caches, s0 + i, enc_out)
                steps.append(logits)
        key = "" if fault is None else f"{fault}/"
        out[key + "logits"] = torch.stack(steps).numpy()
        out[key + "tokens"] = torch.cat(toks, dim=1).numpy()
        if "k" in caches[0]:
            out[key + "cache_k"] = caches[0]["k"].numpy()
        if job.get("codes"):
            out[key + "row_codes_unequal"] = np.array(codes.unequal)
            for i, (q, scale) in enumerate(codes.codes):
                out[f"{key}row_codes/{i}"] = q.numpy()
                out[f"{key}row_scales/{i}"] = scale.numpy()
    if mesh.rank == 0:
        np.savez(os.path.join(d, "out.npz"), **out)


def pipeline_case(mesh, d, job):
    """tests/test_pipeline.py's stack: L tanh layers in S stages over the
    pod axis, M microbatches; the outputs and the gradient of
    sum(out * r) with respect to every layer."""
    world = mesh.size
    with np.load(os.path.join(d, "inputs.npz")) as z:
        w, x, r = (torch.from_numpy(z[k]) for k in ("w", "x", "r"))
    staged = pipeline.split_layers_into_stages({"w": w}, world)
    local = {"w": sh.local_shard(staged["w"], ("pod",), mesh).requires_grad_(True)}

    def stage_fn(params, h):
        for wi in params["w"]:
            h = torch.tanh(h @ wi)
        return h

    y = pipeline.pipeline_apply(stage_fn, local, x, mesh, axis="pod")
    (y * r).sum().backward()
    grads = comm.all_gather(local["w"].grad, mesh.group("pod"), 0)
    out = {"y": y.detach().numpy(), "grad": grads.reshape(w.shape).numpy()}
    np.savez(os.path.join(d, f"out{mesh.rank}.npz"), **out)


def census_case(mesh, d, job):
    """One train step at the mesh under the collective census: each rank
    writes its census (kind -> wire bytes) to census<rank>.json."""
    cfg = _cfg(job)
    plan = sh.Plan(cfg, mesh)
    tc = _tc(job)
    params = plan.shard(init_lm_f32(cfg))
    opt = init_opt(params, tc)
    with comm.census() as rec:
        make_train_step(cfg, tc, plan=plan)(params, opt, _batch(cfg, job, 0))
    with open(os.path.join(d, f"census{mesh.rank}.json"), "w") as f:
        json.dump(rec, f)


CASES = {"census": census_case, "train": train_case, "restore": restore_case, "grads": grads_case,
         "serve": serve_case, "pipeline": pipeline_case}


def _world(job) -> int:
    return job["world"] if job["case"] == "pipeline" else job["data"] * job["model"]


def suite(rank, world, dev, jobs):
    for job in jobs:
        n = _world(job)
        mesh_cfg = (MeshConfig(pod=n) if job["case"] == "pipeline"
                    else MeshConfig(data=job["data"], model=job["model"],
                                    fsdp=job.get("fsdp", True)))
        kv_rep = sh.kv_replication(_cfg(job), mesh_cfg.model) if "arch" in job else 1
        mesh = mesh_lib.make_mesh(mesh_cfg, ranks=range(n), kv_rep=kv_rep)
        if mesh is not None:
            CASES[job["case"]](mesh, job["dir"], job)
        torch.distributed.barrier()


# --- the tests' side ------------------------------------------------------------------

def flat_paths(tree, prefix=""):
    """{"a/b": float32 array} of a nested dict of arrays, in sorted key
    order (JAX's flattening)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat_paths(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, dtype=np.float32)}


def start_suite(d, jobs):
    """Start the case jobs (each with its "dir") in one world of ranks, in
    a subprocess; `finish_suite` waits for it.  The callers compute their
    references meanwhile."""
    with open(os.path.join(d, "suite.json"), "w") as f:
        json.dump(jobs, f)
    with open(os.path.join(d, "suite.log"), "w") as log:   # a file: no pipe to fill
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), str(d)],
                                stdout=log, stderr=subprocess.STDOUT)
    proc.log = os.path.join(d, "suite.log")
    return proc


def finish_suite(proc, jobs, timeout: float = 240):
    """Each job's outputs, in order (a pipeline job: a list, one per rank)."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    with open(proc.log) as f:
        log = f.read()
    assert proc.returncode == 0, log[-8000:]
    outs = []
    for job in jobs:
        if job["case"] == "pipeline":
            outs.append([dict(np.load(os.path.join(job["dir"], f"out{i}.npz")))
                         for i in range(job["world"])])
        elif job["case"] == "census":
            outs.append([json.load(open(os.path.join(job["dir"], f"census{i}.json")))
                         for i in range(_world(job))])
        else:
            with np.load(os.path.join(job["dir"], "out.npz")) as z:
                outs.append({k: z[k] for k in z.files})
    return outs


def run_suite(d, jobs, timeout: float = 240):
    """Run the case jobs (each with its "dir") in one world; returns each
    job's outputs, in order (a pipeline job: a list, one per rank)."""
    return finish_suite(start_suite(d, jobs), jobs, timeout)


def main():
    d = sys.argv[1]
    with open(os.path.join(d, "suite.json")) as f:
        jobs = json.load(f)
    mesh_lib.spawn(suite, max(_world(j) for j in jobs), (jobs,), device="cpu", timeout=200)


if __name__ == "__main__":
    main()
