"""One process of a tensor-parallel test of the PyTorch package
(tests/test_torch_tp.py, tests/test_torch_offload_dp.py): `python
tests/torch_tp_worker.py <dir>` under RANK / WORLD_SIZE / MASTER_ADDR /
MASTER_PORT.

It joins the gloo process group and runs `<dir>/jobs.pt`'s jobs in order, all
in this one group (each builds its own mesh, so one launch covers several
layouts of the same process count), writing `<dir>/<job>-rank<r>.pt`:

- "step": one train_step of the tiny model (with `heads`, its (q, kv)
  heads, from the canonical params `inputs.pt[params]`) at (pp, dp, tp) on
  this process's replica rows of `inputs.pt`'s batch, with ZeRO-1 moments at
  dp > 1, the pipeline's host tiers `tiers` (PipelineConfig's offload
  knobs) and the numerics observatory's stats (process 0 writes them to
  `<dir>/<job>/numerics.jsonl` through the monitor): loss, norm, this
  process's gradients and masters (its tp slices, named as the optimizer
  names them), its moments and their dims, the bytes of its host rings and
  its pushes to them; with `eval`, first the loss-only pass (eval_step) over
  its replica rows of `inputs.pt`'s eval batch: (loss sum, valid count);
- "init": the trainer's init of what this process holds
  (init_params_sharded);
- "ops": tp_copy / tp_reduce / tp_max and the vocab-parallel CE over this
  stage's tp group, forward and backward, on inputs.pt's tensors;
- "train": build_run and train_run on a config and overrides: the losses
  and, under the host optimizer, the shapes of its masters and moments (its
  slices) beside the whole leaves'; with `eval`, first the trainer's
  `eval_sum_count` of each batch of its `eval_dataset` (this replica's
  rows), beside those rows;
- "copy": process 0 copies checkpoint directories, then every process
  waits for it;
- "resave": a run built on a config (resuming its output_dir's newest
  checkpoint) saves that step again at once, into `save_dir` (not the
  directory its peers may still be reading);
- "generate": decode with tp-sharded params over the tp group of (pp, dp,
  tp): this rank's Megatron shard of `inputs.pt`'s params, greedy
  `generate` on its left-padded prompts, `forward_with_cache` logits of the
  prompt (prefill) and of one decode step on the greedy tokens' first, and
  a seeded sampling run.

Not a test module: it imports no JAX, so a process starts in a few seconds.
"""

import os
import sys

import torch

from llama_pipeline_parallel_tpu_torch import train as t_train
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig
from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest
from llama_pipeline_parallel_tpu_torch.optim.optimizer import AdamW, OptimizerConfig, Zero1AdamW
from llama_pipeline_parallel_tpu_torch.parallel import distributed
from llama_pipeline_parallel_tpu_torch.parallel import pipeline as pl
from llama_pipeline_parallel_tpu_torch.parallel import tp as t_tp
from llama_pipeline_parallel_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from llama_pipeline_parallel_tpu_torch.parallel.train_step import (
    TrainState,
    eval_step,
    init_params_sharded,
    train_step,
)
from llama_pipeline_parallel_tpu_torch.utils import numerics
from llama_pipeline_parallel_tpu_torch.utils.config import load_config


def replica_rows(batch: dict, mesh) -> dict:
    """This process's replica's rows of a global batch."""
    rows = batch["input_ids"].shape[0] // mesh.dp
    return {k: v[mesh.replica * rows:(mesh.replica + 1) * rows] for k, v in batch.items()}


def step(job: dict, inputs: dict) -> dict:
    q, kv = job["heads"]
    cfg = LlamaConfig.tiny(num_attention_heads=q, num_key_value_heads=kv)
    canonical = inputs[job["params"]]
    mesh = make_mesh(MeshConfig(pp=job["pp"], dp=job["dp"], tp=job["tp"]))
    m = job["microbatches"]
    batch = replica_rows(inputs["batch"], mesh)
    pipe = None
    v = job.get("v", 1)
    manifest = StageManifest(num_layers=cfg.num_hidden_layers, num_stages=mesh.pp,
                             virtual_stages=v)
    if mesh.pp > 1:
        sp = pl.StageParams.from_canonical(canonical, manifest, mesh.stages,
                                           tp_rank=mesh.tp_rank, tp=mesh.tp)
        pcfg = pl.PipelineConfig(num_stages=mesh.pp, num_microbatches=m,
                                 schedule=job.get("schedule", "1f1b"), virtual_stages=v,
                                 kernel_prologue=job.get("prologue", False),
                                 **job.get("tiers", {}))
        pipe = pl.Pipeline(cfg, pcfg, mesh, sp)
        params = sp.flat()
    else:
        params = {k: t_tp.tp_shard(k, v, mesh.tp_rank, mesh.tp).clone().requires_grad_()
                  for k, v in canonical.items()}
    ocfg = OptimizerConfig(**inputs["optimizer"])
    optimizer = (Zero1AdamW(params, ocfg, mesh.dp, mesh.replica, mesh.dp_group, tp=mesh.tp)
                 if mesh.dp > 1 else AdamW(params, ocfg))
    evaluated = None
    if job.get("eval"):
        evaluated = eval_step(params, replica_rows(inputs["eval_batch"], mesh), cfg,
                              num_microbatches=m, kernel_prologue=job.get("prologue", False),
                              pipeline=pipe, dp_group=mesh.dp_group, tp_group=mesh.tp_group)
    state = TrainState(step=0, params=params, optimizer=optimizer)
    metrics = train_step(state, batch, cfg, num_microbatches=m, remat=True, pipeline=pipe,
                         kernel_prologue=job.get("prologue", False), dp_group=mesh.dp_group,
                         tp_group=mesh.tp_group, collect_stats=True, mesh=mesh,
                         manifest=manifest)
    monitor = numerics.NumericsMonitor(os.path.join(job["out_dir"], job["name"]),
                                       numerics.NumericsConfig(), write=mesh.rank == 0)
    monitor.observe(1, metrics["loss"], metrics["grad_norm"], metrics["numerics"])
    monitor.flush()
    monitor.close()
    return {"loss": metrics["loss"], "norm": metrics["grad_norm"], "replica": mesh.replica,
            "stages": mesh.stages, "tp_rank": mesh.tp_rank,
            "grads": {k: p.grad for k, p in params.items()},
            "masters": {k: p.detach() for k, p in params.items()},
            "mu": optimizer.mu, "dims": getattr(optimizer, "dims", None), "eval": evaluated,
            "host_stash_bytes": 0 if pipe is None else pipe.host_stash_bytes(),
            "pushes": 0 if pipe is None else sum(e[0] == "push" for e in pipe.stash_trace)}


def init(job: dict, inputs: dict) -> dict:
    cfg = LlamaConfig.tiny()
    mesh = make_mesh(MeshConfig(pp=job["pp"], dp=job["dp"], tp=job["tp"]))
    manifest = StageManifest(num_layers=cfg.num_hidden_layers, num_stages=mesh.pp)
    chunks = init_params_sharded(cfg, job["seed"], manifest, mesh.stages, tp_rank=mesh.tp_rank,
                                 tp=mesh.tp, device="cpu")
    return {"chunks": chunks, "tp_rank": mesh.tp_rank, "replica": mesh.replica}


def ops(job: dict, inputs: dict) -> dict:
    """The tp operators over the tp group of (pp, dp, tp): each rank's
    input x[t] through tp_copy (backward g[t]), tp_reduce and tp_max, and
    the vocab-parallel CE of h against this rank's lm_head columns."""
    mesh = make_mesh(MeshConfig(pp=job["pp"], dp=job["dp"], tp=job["tp"]))
    t, group = mesh.tp_rank, mesh.tp_group
    out = {"tp_rank": t}
    x = inputs["x"][t].clone().requires_grad_()
    y = t_tp.tp_copy(x, group)
    y.backward(inputs["g"][t])
    out["copy"], out["copy_grad"] = y.detach(), x.grad
    x = inputs["x"][t].clone().requires_grad_()
    y = t_tp.tp_reduce(x, group)
    y.backward(inputs["g"][t])
    out["reduce"], out["reduce_grad"] = y.detach(), x.grad
    x = inputs["x"][t].clone().requires_grad_()
    y = t_tp.tp_max(x, group)
    y.backward(inputs["g"][t])
    out["max"], out["max_grad"] = y.detach(), x.grad
    h = inputs["h"].clone().requires_grad_()
    w = t_tp.tp_shard("lm_head", inputs["lm_head"], t, mesh.tp).clone().requires_grad_()
    loss, count = t_tp.vocab_parallel_loss_sum_count(h, w, inputs["targets"], group, -100)
    loss.backward()
    out.update(ce_loss=loss.detach(), ce_count=count, ce_dh=h.grad, ce_dw=w.grad)
    return out


def train(job: dict, inputs: dict) -> dict:
    run = t_train.build_run(load_config(job["config"], job["overrides"]), device="cpu")
    out = {}
    if job.get("eval"):
        batches = list(run.eval_loader)
        out["eval"] = [run.eval_sum_count(run.on_device(b)) for b in batches]
        out["eval_batches"] = [run.on_device(b) for b in batches]
        out["microbatches"] = run.num_microbatches
    out.update(losses=t_train.train_run(run)["losses"], replica=run.mesh.replica,
               tp_rank=run.mesh.tp_rank, stages=run.mesh.stages)
    if run.host is not None:
        host = run.host
        out["host"] = {name: (tuple(host.masters[name].shape), tuple(host.m[name].shape),
                              tuple(host.v[name].shape), host._whole_shape(name),
                              (host.dims or {}).get(name)) for name in host.masters}
    return out


def copy(job: dict, inputs: dict) -> dict:
    import shutil

    if distributed.process_index() == 0:
        for src, dst in job["pairs"]:
            shutil.copytree(src, dst)
    distributed.barrier("copy")
    return {}


def resave(job: dict, inputs: dict) -> dict:
    from llama_pipeline_parallel_tpu_torch.ckpt.checkpoint import CheckpointManager

    run = t_train.build_run(load_config(job["config"], job["overrides"]), device="cpu")
    run.ckpt = CheckpointManager(job["save_dir"])
    run.save(run.start_step, final=True)
    return {"step": run.start_step}


def generate(job: dict, inputs: dict) -> dict:
    import torch.nn.functional as F

    from llama_pipeline_parallel_tpu_torch.models.llama import decode

    cfg = LlamaConfig.tiny(dtype=torch.float32)
    mesh = make_mesh(MeshConfig(pp=job["pp"], dp=job["dp"], tp=job["tp"]))
    group = mesh.tp_group
    shard = {k: t_tp.tp_shard(k, v, mesh.tp_rank, mesh.tp).clone()
             for k, v in inputs["params"].items()}
    ids, mask = inputs["gen_ids"], inputs["gen_mask"]
    greedy = decode.generate(shard, ids, mask, cfg, decode.GenerationConfig(**job["greedy"]),
                             tp_group=group)["tokens"]
    b, p = ids.shape
    cache = decode.init_kv_cache(cfg, b, p + 1, device="cpu", tp=mesh.tp)
    kv_mask = F.pad(mask.to(torch.int32), (0, 1))
    positions = (mask.cumsum(1) - 1).clamp_min(0)
    prefill, cache = decode.forward_with_cache(shard, ids, cache, positions, 0, kv_mask, cfg,
                                               tp_group=group)
    kv_mask[:, p] = 1
    step_logits, _ = decode.forward_with_cache(shard, greedy[:, :1], cache,
                                               positions[:, -1:] + 1, p, kv_mask, cfg,
                                               causal=False, tp_group=group)
    sampled = decode.generate(shard, ids, mask, cfg, decode.GenerationConfig(**job["sampled"]),
                              generator=torch.Generator().manual_seed(job["seed"]),
                              tp_group=group)["tokens"]
    return {"tp_rank": mesh.tp_rank, "greedy": greedy, "prefill": prefill,
            "step": step_logits, "sampled": sampled}


JOBS = {"step": step, "init": init, "ops": ops, "train": train, "copy": copy,
        "resave": resave, "generate": generate}


def main(out_dir: str) -> None:
    distributed.initialize_distributed("cpu")
    rank = distributed.process_index()
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"))
    for job in torch.load(os.path.join(out_dir, "jobs.pt")):
        result = JOBS[job["kind"]]({**job, "out_dir": out_dir}, inputs)
        torch.save(result, os.path.join(out_dir, f"{job['name']}-rank{rank}.pt"))
    distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
