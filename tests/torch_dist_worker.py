"""One process of a multi-process test of the PyTorch package
(tests/test_torch_dp.py): `python tests/torch_dist_worker.py step <dir> <pp>
<dp> <schedule>` under RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT.

It reads `<dir>/inputs.pt` (canonical params, the global batch, the number of
microbatches and the optimizer config), joins the gloo process group, runs
one train_step of the tiny model at pp x dp with ZeRO-1 moments on this
process's replica rows, with the numerics observatory's stats (process 0
writes them to `<dir>/numerics.jsonl` through the monitor), and writes
`<dir>/rank<r>.pt`: the loss, the gradient norm, the gradients (summed over
dp), the masters after the update, the moments this process holds and the
dims they are split on. In the same process group, where inputs.pt holds
them:
- "eval_batch": before the step, the loss-only pass (eval_step; the
  pipeline's loss_sum_count at pp > 1) over this replica's rows: "eval",
  (loss sum, valid count);
- "variants" ({name: (schedule, PipelineConfig offload knobs)}, pp > 1):
  after the step, each variant's pipeline loss_and_grad from the same
  params on the same rows: "variants", {name: (loss, gradients, bytes of the
  host rings, pushes to them)}.
Not a test module: it imports no JAX, so a process starts in a few seconds.
"""

import os
import sys

import torch

from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig
from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest
from llama_pipeline_parallel_tpu_torch.optim.optimizer import OptimizerConfig, Zero1AdamW
from llama_pipeline_parallel_tpu_torch.parallel import distributed
from llama_pipeline_parallel_tpu_torch.parallel import pipeline as pl
from llama_pipeline_parallel_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from llama_pipeline_parallel_tpu_torch.parallel.train_step import TrainState, eval_step, train_step
from llama_pipeline_parallel_tpu_torch.utils import numerics


def step(out_dir: str, pp: int, dp: int, schedule: str) -> None:
    distributed.initialize_distributed("cpu")
    rank = distributed.process_index()
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"))
    cfg = LlamaConfig.tiny()
    mesh = make_mesh(MeshConfig(pp=pp, dp=dp))
    m = inputs["microbatches"]
    rows = inputs["batch"]["input_ids"].shape[0] // dp

    def replica_rows(global_batch):
        return {k: v[mesh.replica * rows:(mesh.replica + 1) * rows]
                for k, v in global_batch.items()}

    batch = replica_rows(inputs["batch"])
    pipe = None
    manifest = StageManifest(num_layers=cfg.num_hidden_layers, num_stages=pp)
    if pp > 1:
        sp = pl.StageParams.from_canonical(inputs["params"], manifest, mesh.stages)
        pcfg = pl.PipelineConfig(num_stages=pp, num_microbatches=m, schedule=schedule)
        pipe = pl.Pipeline(cfg, pcfg, mesh, sp)
        params = sp.flat()
    else:
        params = {k: v.clone().requires_grad_() for k, v in inputs["params"].items()}
    optimizer = Zero1AdamW(params, OptimizerConfig(**inputs["optimizer"]), dp, mesh.replica,
                           mesh.dp_group)
    evaluated = None
    if "eval_batch" in inputs:
        evaluated = eval_step(params, replica_rows(inputs["eval_batch"]), cfg,
                              num_microbatches=m, pipeline=pipe, dp_group=mesh.dp_group)
    state = TrainState(step=0, params=params, optimizer=optimizer)
    metrics = train_step(state, batch, cfg, num_microbatches=m, remat=True, pipeline=pipe,
                         dp_group=mesh.dp_group, collect_stats=True, mesh=mesh,
                         manifest=manifest)
    monitor = numerics.NumericsMonitor(out_dir, numerics.NumericsConfig(), write=rank == 0)
    monitor.observe(1, metrics["loss"], metrics["grad_norm"], metrics["numerics"])
    monitor.flush()
    monitor.close()
    variants = {}
    for name, (schedule_v, tiers) in inputs.get("variants", {}).items():
        sp = pl.StageParams.from_canonical(inputs["params"], manifest, mesh.stages)
        pcfg = pl.PipelineConfig(num_stages=pp, num_microbatches=m, schedule=schedule_v,
                                 **tiers)
        pipe_v = pl.Pipeline(cfg, pcfg, mesh, sp)
        loss = pipe_v.loss_and_grad(batch)
        variants[name] = (loss, {k: p.grad for k, p in sp.flat().items()},
                          pipe_v.host_stash_bytes(),
                          sum(e[0] == "push" for e in pipe_v.stash_trace))
    torch.save({"loss": metrics["loss"], "norm": metrics["grad_norm"],
                "replica": mesh.replica, "stages": mesh.stages,
                "grads": {k: p.grad for k, p in params.items()},
                "masters": {k: p.detach() for k, p in params.items()},
                "mu": optimizer.mu, "dims": optimizer.dims, "eval": evaluated,
                "variants": variants},
               os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    if sys.argv[1] == "step":
        step(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
