"""Faults planted under the timed path, to show that the comparison catches them.

Each takes a harness.Program before its first step and breaks it in place:

- `unchanged`: the step returns its state unchanged (the optimizer applies
  nothing);
- `half_batch`: half of every batch is left out and the mean taken over the
  rest (the second half of the rows, or of the one row, loses its targets).

One chip has no exchange between chips to leave out, and a training step
produces no token to alter. Used by the harness's tests and by control.py,
never by a benchmark run.
"""

from __future__ import annotations

IGNORE_INDEX = -100


def unchanged(prog) -> None:
    opt = prog.run.state.optimizer
    opt.step = lambda *args, **kwargs: opt.schedule(opt.count)


def half_batch(prog) -> None:
    run = prog.run
    inner = run.step

    def step(batch, *args, **kwargs):
        labels = batch["labels"].clone()
        rows, seq = labels.shape
        if rows > 1:
            labels[rows // 2:] = IGNORE_INDEX
        else:
            labels[:, seq // 2:] = IGNORE_INDEX
        return inner(dict(batch, labels=labels), *args, **kwargs)

    run.step = step


FAULTS = {"unchanged": unchanged, "half_batch": half_batch}
