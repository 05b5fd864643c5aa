"""One process of a sequence-parallel test of the PyTorch package
(tests/test_torch_sp.py): `python tests/torch_sp_worker.py <dir>` under RANK /
WORLD_SIZE / MASTER_ADDR / MASTER_PORT.

It joins the gloo process group and runs `<dir>/jobs.pt`'s jobs in order, all
in this one group (each builds its own mesh), writing `<dir>/<job>-rank<r>.pt`:

- "ring": ring_attention over the sp group of (dp, sp) on this process's
  slab of `inputs.pt`'s q / k / v (and segment ids when `packed`), forward
  and backward with its slab of the cotangent: out, dq, dk, dv;
- "ulysses": ulysses_attention the same way, GQA, with the segment ids;
- "step": one train_step of the tiny model at (pp, dp, tp, sp) on this
  process's replica rows and column slab of the batch (the eval pass first
  where `eval`): loss, norm, this process's gradients (its stage's chunks,
  its tp slices) and its place in the mesh;
- "train": tests/torch_tp_worker.py's (build_run and train_run on a config
  and overrides: the losses);
- "refuse": build_run on a config that must be refused: the message.

Not a test module: it imports no JAX, so a process starts in a few seconds.
"""

import os
import sys

import torch
import torch_tp_worker

from llama_pipeline_parallel_tpu_torch import train as t_train
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig
from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest
from llama_pipeline_parallel_tpu_torch.ops.attention import attention
from llama_pipeline_parallel_tpu_torch.ops.flash_attention import flash_attention
from llama_pipeline_parallel_tpu_torch.optim.optimizer import AdamW, OptimizerConfig, Zero1AdamW
from llama_pipeline_parallel_tpu_torch.parallel import distributed
from llama_pipeline_parallel_tpu_torch.parallel import pipeline as pl
from llama_pipeline_parallel_tpu_torch.parallel import tp as t_tp
from llama_pipeline_parallel_tpu_torch.parallel.mesh import MeshConfig, make_mesh, sp_slab
from llama_pipeline_parallel_tpu_torch.parallel.ring_attention import ring_attention
from llama_pipeline_parallel_tpu_torch.parallel.sp import make_sp_attention
from llama_pipeline_parallel_tpu_torch.parallel.train_step import TrainState, train_step
from llama_pipeline_parallel_tpu_torch.parallel.ulysses import ulysses_attention
from llama_pipeline_parallel_tpu_torch.utils.config import load_config

ATTN = {"exact": attention, "flash": flash_attention}


def _attention_job(job: dict, inputs: dict, op) -> dict:
    mesh = make_mesh(MeshConfig(dp=job["dp"], sp=job["sp"]))
    case = {name: x.contiguous() for name, x in sp_slab(inputs["attn"][job["case"]],
                                                         mesh).items()}
    q, k, v = (case[n].requires_grad_() for n in ("q", "k", "v"))
    out = op(q, k, v, case["seg"] if job.get("packed") else None, mesh)
    out.backward(case["dout"])
    return {"sp_rank": mesh.sp_rank, "out": out.detach(), "dq": q.grad, "dk": k.grad,
            "dv": v.grad}


def ring(job: dict, inputs: dict) -> dict:
    return _attention_job(job, inputs, lambda q, k, v, seg, mesh: ring_attention(
        q, k, v, seg, causal=True, group=mesh.sp_group, backend=job["backend"]))


def ulysses(job: dict, inputs: dict) -> dict:
    return _attention_job(job, inputs, lambda q, k, v, seg, mesh: ulysses_attention(
        q, k, v, seg, causal=True, group=mesh.sp_group, inner_attn=ATTN[job["inner"]]))


def step(job: dict, inputs: dict) -> dict:
    cfg = LlamaConfig.tiny()
    canonical = inputs["params"]
    mesh = make_mesh(MeshConfig(pp=job["pp"], dp=job["dp"], tp=job["tp"], sp=job["sp"]))
    m = job["microbatches"]
    rows = inputs["batch"]["input_ids"].shape[0] // mesh.dp
    batch = sp_slab({k: v[mesh.replica * rows:(mesh.replica + 1) * rows]
                     for k, v in inputs["batch"].items()}, mesh)
    attn = ATTN[job["attention"]]
    pipe = None
    out = {}
    if mesh.pp > 1:
        manifest = StageManifest(num_layers=cfg.num_hidden_layers, num_stages=mesh.pp)
        sp = pl.StageParams.from_canonical(canonical, manifest, mesh.stages,
                                           tp_rank=mesh.tp_rank, tp=mesh.tp)
        pcfg = pl.PipelineConfig(num_stages=mesh.pp, num_microbatches=m,
                                 schedule=job["schedule"], kernel_ce=job["ce"],
                                 loss_chunks=job["loss_chunks"],
                                 kernel_prologue=job["prologue"],
                                 sequence_parallel=job["strategy"])
        pipe = pl.Pipeline(cfg, pcfg, mesh, sp, attn)
        params = sp.flat()
        if job.get("eval"):
            out["eval"] = pipe.loss_sum_count(batch)
    else:
        params = {k: t_tp.tp_shard(k, v, mesh.tp_rank, mesh.tp).clone().requires_grad_()
                  for k, v in canonical.items()}
        attn = make_sp_attention(job["strategy"], attn, mesh.sp_group)
    ocfg = OptimizerConfig(**inputs["optimizer"])
    optimizer = (Zero1AdamW(params, ocfg, mesh.dp, mesh.replica, mesh.dp_group, tp=mesh.tp)
                 if mesh.dp > 1 else AdamW(params, ocfg))
    state = TrainState(step=0, params=params, optimizer=optimizer)
    metrics = train_step(state, batch, cfg, num_microbatches=m, remat=True, pipeline=pipe,
                         attn_fn=attn, kernel_prologue=job["prologue"],
                         dp_group=mesh.dp_group, tp_group=mesh.tp_group,
                         sp_group=mesh.sp_group)
    out.update(loss=metrics["loss"], norm=metrics["grad_norm"], stages=mesh.stages,
               replica=mesh.replica, tp_rank=mesh.tp_rank, sp_rank=mesh.sp_rank,
               grads={k: p.grad for k, p in params.items()})
    return out


def refuse(job: dict, inputs: dict) -> dict:
    try:
        t_train.build_run(load_config(job["config"], job["overrides"]), device="cpu")
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


JOBS = {"ring": ring, "ulysses": ulysses, "step": step, "refuse": refuse,
        "train": torch_tp_worker.train}


def main(out_dir: str) -> None:
    distributed.initialize_distributed("cpu")
    rank = distributed.process_index()
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"))
    for job in torch.load(os.path.join(out_dir, "jobs.pt")):
        result = JOBS[job["kind"]](job, inputs)
        torch.save(result, os.path.join(out_dir, f"{job['name']}-rank{rank}.pt"))
    distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
