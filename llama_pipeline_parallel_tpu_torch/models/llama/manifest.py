"""Layer -> pipeline-stage manifest.

A copy of llama_pipeline_parallel_tpu/models/llama/manifest.py (pure Python:
dataclasses, json and the config), importing this package's LlamaConfig. The
mapping of layers to pipeline stages is one explicit, serializable object:
the checkpoint records it in meta.json (`manifest`), and the pipeline
runtime consumes it.

Uneven partitions: `layer_counts` assigns each stage its own layer count. The
stacked runtime layout pads every stage to `max_layers_per_stage` slots;
padded slots hold ZERO weights, which makes the residual decoder block an
exact identity with identically zero gradients (a fixed point of AdamW).
"""

from __future__ import annotations

import dataclasses
import json

from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig


@dataclasses.dataclass(frozen=True)
class StageManifest:
    num_layers: int
    num_stages: int
    # None -> even split (num_layers % num_stages must be 0). Otherwise one
    # count per stage, each >= 1, summing to num_layers.
    layer_counts: tuple | None = None
    # Interleaved scheduling (schedule: interleaved_1f1b or zb1): each stage
    # owns `virtual_stages` NON-CONTIGUOUS chunks of layers, assigned
    # round-robin over global chunks — chunk c (of num_stages *
    # virtual_stages equal chunks, in layer order) lives on stage
    # c % num_stages as its virtual chunk c // num_stages, so the activation
    # ring passes through every stage `virtual_stages` times per microbatch.
    # 1 = the flat contiguous partition (every existing checkpoint/manifest
    # deserializes to it). The manifest is SCHEDULE-AGNOSTIC on disk: the
    # canonical [num_layers, ...] checkpoint layout never changes, so any
    # checkpoint restores into flat, interleaved, or zb1 layouts through the
    # same stack/unstack pair.
    virtual_stages: int = 1

    def __post_init__(self) -> None:
        if self.num_stages < 1:
            raise ValueError(f"num_stages must be >= 1, got {self.num_stages}")
        if self.virtual_stages < 1:
            raise ValueError(
                f"virtual_stages must be >= 1, got {self.virtual_stages}")
        if self.virtual_stages > 1:
            if self.layer_counts is not None:
                raise ValueError(
                    "virtual_stages > 1 requires an even partition: the "
                    "round-robin chunk assignment has no uneven form — drop "
                    "layer_counts or set virtual_stages: 1")
            denom = self.num_stages * self.virtual_stages
            if self.num_layers % denom:
                raise ValueError(
                    f"num_layers={self.num_layers} not divisible by "
                    f"num_stages*virtual_stages={denom}; interleaved "
                    f"scheduling needs equal-size chunks")
        if self.layer_counts is None:
            if self.num_layers % self.num_stages:
                raise ValueError(
                    f"num_layers={self.num_layers} not divisible by "
                    f"num_stages={self.num_stages}; pass layer_counts for an "
                    f"uneven partition (or use StageManifest.balanced)")
        else:
            counts = tuple(int(c) for c in self.layer_counts)
            object.__setattr__(self, "layer_counts", counts)
            if len(counts) != self.num_stages:
                raise ValueError(
                    f"layer_counts has {len(counts)} entries for "
                    f"num_stages={self.num_stages}")
            if any(c < 1 for c in counts):
                raise ValueError(f"every stage needs >= 1 layer, got {counts}")
            if sum(counts) != self.num_layers:
                raise ValueError(
                    f"layer_counts {counts} sum to {sum(counts)}, expected "
                    f"num_layers={self.num_layers}")

    @property
    def is_even(self) -> bool:
        return (self.layer_counts is None
                or len(set(self.layer_counts)) == 1)

    @property
    def stage_layer_counts(self) -> tuple:
        if self.layer_counts is not None:
            return self.layer_counts
        return (self.num_layers // self.num_stages,) * self.num_stages

    @property
    def layers_per_stage(self) -> int:
        """Uniform per-stage count — only meaningful for even partitions."""
        if not self.is_even:
            raise ValueError(
                f"layers_per_stage is undefined for the uneven partition "
                f"{self.layer_counts}; use stage_layer_counts/max_layers_per_stage")
        return self.stage_layer_counts[0]

    @property
    def max_layers_per_stage(self) -> int:
        """Slot count of the padded stacked layout [num_stages, k_max, ...]."""
        return max(self.stage_layer_counts)

    # -- interleaved (virtual_stages > 1) chunk geometry --------------------

    @property
    def layers_per_chunk(self) -> int:
        """Layer count of one virtual chunk — the k of the interleaved
        stacked layout [num_stages, virtual_stages, k, ...]."""
        return self.num_layers // (self.num_stages * self.virtual_stages)

    def chunk_of_layer(self, layer_idx: int) -> tuple:
        """(stage, virtual_chunk) of a layer under the round-robin
        assignment ((stage, 0) for every layer of a flat manifest's stage)."""
        if not 0 <= layer_idx < self.num_layers:
            raise ValueError(f"layer {layer_idx} out of range [0, {self.num_layers})")
        if self.virtual_stages == 1:
            return self.stage_of_layer(layer_idx), 0
        c = layer_idx // self.layers_per_chunk
        return c % self.num_stages, c // self.num_stages

    def layers_of_chunk(self, stage: int, virtual_chunk: int) -> range:
        """Layer range of one (stage, virtual_chunk) cell."""
        if not 0 <= stage < self.num_stages:
            raise ValueError(f"stage {stage} out of range [0, {self.num_stages})")
        if not 0 <= virtual_chunk < self.virtual_stages:
            raise ValueError(f"virtual chunk {virtual_chunk} out of range "
                             f"[0, {self.virtual_stages})")
        if self.virtual_stages == 1:
            return self.layers_of_stage(stage)
        k = self.layers_per_chunk
        off = (virtual_chunk * self.num_stages + stage) * k
        return range(off, off + k)

    # embed lives on the first stage, final norm + lm head on the last
    embed_stage: int = 0

    @property
    def head_stage(self) -> int:
        return self.num_stages - 1

    def stage_offsets(self) -> tuple:
        """Start layer index of each stage (cumulative counts)."""
        out, acc = [], 0
        for c in self.stage_layer_counts:
            out.append(acc)
            acc += c
        return tuple(out)

    def stage_of_layer(self, layer_idx: int) -> int:
        if not 0 <= layer_idx < self.num_layers:
            raise ValueError(f"layer {layer_idx} out of range [0, {self.num_layers})")
        if self.virtual_stages > 1:
            return (layer_idx // self.layers_per_chunk) % self.num_stages
        for s, (off, c) in enumerate(zip(self.stage_offsets(),
                                         self.stage_layer_counts)):
            if off <= layer_idx < off + c:
                return s
        raise AssertionError("unreachable")

    def layers_of_stage(self, stage: int):
        """Layer indices owned by one stage: a contiguous range for flat
        manifests, the sorted union of the stage's virtual chunks (a list —
        NON-contiguous) under interleaving."""
        if not 0 <= stage < self.num_stages:
            raise ValueError(f"stage {stage} out of range [0, {self.num_stages})")
        if self.virtual_stages > 1:
            return [layer for vc in range(self.virtual_stages)
                    for layer in self.layers_of_chunk(stage, vc)]
        off = self.stage_offsets()[stage]
        return range(off, off + self.stage_layer_counts[stage])

    @staticmethod
    def for_config(cfg: LlamaConfig, num_stages: int,
                   virtual_stages: int = 1) -> "StageManifest":
        return StageManifest(num_layers=cfg.num_hidden_layers,
                             num_stages=num_stages,
                             virtual_stages=virtual_stages)

    @staticmethod
    def balanced(cfg: LlamaConfig, num_stages: int,
                 embed_weight: float | None = None,
                 head_weight: float | None = None) -> "StageManifest":
        """Cost-balanced partition: minimize the max per-stage cost, where a
        stage's cost is its decoder-layer count plus the embed / lm-head
        weight (in layer units) it hosts.

        Default weights come from the model's matmul flops: one decoder layer
        moves ~2*(2*d^2 + 2*d*kv + 3*d*f) flops/token forward; the lm-head
        (and its loss softmax) ~2*d*V; the embedding gather is ~free forward
        but its backward is a scatter into [V, d], counted like half a head.
        (DeepSpeed's partition_method="parameters" analogue.)
        """
        d, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
        kv_dim = cfg.kv_heads * cfg.head_dim
        layer_cost = 2 * d * d + 2 * d * kv_dim + 3 * d * f
        if head_weight is None:
            head_weight = (d * v) / layer_cost
        if embed_weight is None:
            embed_weight = 0.5 * (d * v) / layer_cost
        n, s = cfg.num_hidden_layers, num_stages
        if s > n:
            raise ValueError(f"num_stages={s} exceeds num_layers={n}: every "
                             f"stage needs at least one decoder layer")
        if s == 1:
            return StageManifest(num_layers=n, num_stages=s)
        extras = [0.0] * s
        extras[0] += embed_weight
        extras[-1] += head_weight

        counts = [1] * s
        for _ in range(n - s):  # greedily grow the currently-cheapest stage
            j = min(range(s), key=lambda i: (counts[i] + extras[i], i))
            counts[j] += 1
        manifest = StageManifest(num_layers=n, num_stages=s,
                                 layer_counts=tuple(counts))
        return (StageManifest(num_layers=n, num_stages=s)
                if manifest.is_even and n % s == 0 else manifest)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "StageManifest":
        return StageManifest(**json.loads(s))
