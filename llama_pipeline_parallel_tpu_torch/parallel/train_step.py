"""The train step on one device: microbatched forward/backward, clip, AdamW.

The counterpart of llama_pipeline_parallel_tpu/parallel/train_step.py at
pp = dp = tp = sp = 1, where the pipeline's `_loss_and_grad_local`
(parallel/pipeline.py) degenerates to:

- count the valid next-token targets over the WHOLE step once;
- for each microbatch, take its loss sum over that global count and
  backpropagate it, accumulating the gradients in fp32 (`.grad` of the fp32
  masters) — so the sum is exactly the full-batch gradient;
- then clip and update.

The loss head is the reference's (`pipeline.py`'s `head`): the dense
lm_head + cross-entropy, or, with `loss_vocab_chunks > 1` or `kernels.ce:
pallas`, a fused head on the final-normed hidden states that never builds the
[tokens, V] logits — the vocab-chunked PyTorch op or the CUDA kernels.

Metrics are `loss`, `grad_norm` (before clipping, computed once and handed
to the optimizer), `lr` (the schedule at the step count before its increment)
and `step`, as in the reference. At pp > 1 the step's forward and backward
are a parallel/pipeline.Pipeline's.

`eval_step` is the loss-only pass (the reference's `make_pipeline_eval_fn`,
parallel/pipeline.py): the same microbatches, head and prologue under
`torch.no_grad()`, returning the (loss sum, valid count) pair so that the
evaluator weights batches exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from llama_pipeline_parallel_tpu_torch.models.llama import model as llama
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig
from llama_pipeline_parallel_tpu_torch.ops.attention import attention
from llama_pipeline_parallel_tpu_torch.ops.cross_entropy import fused_ce_sum_count
from llama_pipeline_parallel_tpu_torch.ops.fused_ce import kernel_ce_sum_count
from llama_pipeline_parallel_tpu_torch.optim.optimizer import AdamW, global_norm


@dataclasses.dataclass
class TrainState:
    step: int
    params: llama.Params  # fp32 masters, requires_grad
    optimizer: AdamW


@dataclasses.dataclass(frozen=True)
class LossHead:
    """Which loss head a step runs: `loss_chunks` vocab chunks
    (`loss_vocab_chunks`), `kernel_ce` the CUDA kernels (`kernels.ce: pallas`)."""

    loss_chunks: int = 1
    kernel_ce: bool = False


def head_loss_sum_count(params: llama.Params, hn: torch.Tensor, targets: torch.Tensor,
                        cfg: LlamaConfig, head: LossHead) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss sum, valid count) of the final-normed hidden states `hn` against
    next-token `targets`, through `head` (reference: pipeline.py's `head`)."""
    if head.loss_chunks > 1 or head.kernel_ce:
        op = kernel_ce_sum_count if head.kernel_ce else fused_ce_sum_count
        return op(hn, params["lm_head"].to(cfg.dtype), targets, head.loss_chunks)
    return llama.token_loss_sum_and_count_preshifted(llama.lm_head(params, hn, cfg), targets)


def shift_labels(labels: torch.Tensor) -> torch.Tensor:
    """Next-token targets aligned with each position; the last position has
    none (IGNORE_INDEX)."""
    tail = torch.full_like(labels[:, :1], llama.IGNORE_INDEX)
    return torch.cat([labels[:, 1:], tail], dim=1)


def microbatches(batch: dict[str, torch.Tensor], num_microbatches: int):
    """(next-token targets [bsz, s], [(ids, mask, positions, targets) for each
    microbatch of `batch`]); mask and positions None where the batch has none."""
    ids = batch["input_ids"]
    bsz = ids.shape[0]
    if bsz % num_microbatches:
        raise ValueError(f"batch {bsz} not divisible by microbatches {num_microbatches}")
    mb = bsz // num_microbatches
    targets = shift_labels(batch["labels"])
    mask, positions = batch.get("attention_mask"), batch.get("position_ids")
    rows = [slice(i * mb, (i + 1) * mb) for i in range(num_microbatches)]
    return targets, [(ids[r], None if mask is None else mask[r],
                      None if positions is None else positions[r], targets[r]) for r in rows]


def train_step(state: TrainState, batch: dict[str, torch.Tensor], cfg: LlamaConfig, *,
               num_microbatches: int = 1, attn_fn: Callable = attention,
               remat: bool = False, head: LossHead = LossHead(),
               kernel_prologue: bool = False, remat_policy: str = "nothing_saveable",
               pipeline: Any = None) -> dict:
    """One optimizer step over `batch` ([num_microbatches * mb, s] tensors on
    the params' device), updating `state` in place. `kernel_prologue` runs
    each layer's norm -> QKV -> RoPE on the fused prologue kernels
    (`kernels.prologue: pallas`); `remat` recomputes each layer in the
    backward under `remat_policy` (model.remat_layer). With `pipeline` (a
    parallel/pipeline.Pipeline whose StageParams.flat() are
    `state.params`) the forward and backward are its schedule's, and the
    other step knobs its config's; the gradient norm then spans every
    stage. Returns the metrics."""
    params = state.params
    for p in params.values():
        p.grad = None
    if pipeline is not None:
        loss = pipeline.loss_and_grad(batch)
        grad_norm = pipeline.global_norm()
    else:
        targets, mbs = microbatches(batch, num_microbatches)
        global_count = (targets != llama.IGNORE_INDEX).sum().clamp(min=1).float()
        loss = torch.zeros((), device=targets.device)
        for ids, mask, positions, mb_targets in mbs:
            hn = llama.hidden_states(params, ids, mask, positions, cfg=cfg, attn_fn=attn_fn,
                                     remat=remat, kernel_prologue=kernel_prologue,
                                     remat_policy=remat_policy)
            mb_loss = head_loss_sum_count(params, hn, mb_targets, cfg, head)[0]
            mb_loss = mb_loss / global_count
            mb_loss.backward()
            loss += mb_loss.detach()
        grad_norm = global_norm(p.grad for p in params.values())
    grads = {name: p.grad for name, p in params.items()}
    lr = state.optimizer.step(params, grads, grad_norm)
    state.step += 1
    return {"loss": loss, "grad_norm": grad_norm, "lr": lr, "step": state.step}


@torch.no_grad()
def eval_step(params: llama.Params, batch: dict[str, torch.Tensor], cfg: LlamaConfig, *,
              num_microbatches: int = 1, attn_fn: Callable = attention,
              head: LossHead = LossHead(), kernel_prologue: bool = False,
              pipeline: Any = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The loss-only pass over `batch` in `num_microbatches` microbatches, on
    the training step's attention, head and prologue, with no autograd graph:
    (token-loss sum fp32, valid-target count) over the whole batch. With
    `pipeline`, its forward-only pass through every stage."""
    if pipeline is not None:
        return pipeline.loss_sum_count(batch)
    targets, mbs = microbatches(batch, num_microbatches)
    loss_sum = torch.zeros((), device=targets.device)
    for ids, mask, positions, mb_targets in mbs:
        hn = llama.hidden_states(params, ids, mask, positions, cfg=cfg, attn_fn=attn_fn,
                                 kernel_prologue=kernel_prologue)
        loss_sum += head_loss_sum_count(params, hn, mb_targets, cfg, head)[0].float()
    return loss_sum, (targets != llama.IGNORE_INDEX).sum()
