"""Programs with a planted fault, put in the port's place to show that
`correct` catches it: in the CPU tests at a small size, and on the card
(`calibrate.py`) at the cell's own size for the faults that set a
training number's upper reading."""
from __future__ import annotations

from h100bench.serve_cell import PortServer
from h100bench.train_cell import PortTrainer


class HalfBatch(PortTrainer):
    """Half of the batch left out: each step's loss is the mean over the
    first half of the rows."""

    def step(self, batch, eps):
        h = eps[0].shape[0] // 2
        return super().step({k: v[:h] for k, v in batch.items()},
                            tuple(e[:h] for e in eps))


class Unchanged(PortTrainer):
    """A step that returns its state unchanged: the loss and its backward
    run, the clip and Adam do not."""

    def step(self, batch, eps):
        return self.trainer.compute_gradients(self.loss_fn, batch, eps)


def _wrap_run(server, alter):
    run = server._run

    def broken(*args, **kwargs):
        out, z = run(*args, **kwargs)
        return alter(out.clone()), z

    server._run = broken


class AlteredToken(PortServer):
    """One token of every served row altered where it is produced."""

    def __init__(self, cell, tree0, device):
        super().__init__(cell, tree0, device)
        V = cell.cfg["roll_dims"]

        def alter(out):
            out[:, 3] = (out[:, 3] + 1) % V
            return out

        _wrap_run(self.server, alter)


class HalfRows(PortServer):
    """Half of each batch left out: the second half of its rows come back
    as zeros."""

    def __init__(self, cell, tree0, device):
        super().__init__(cell, tree0, device)

        def alter(out):
            out[out.shape[0] // 2:] = 0
            return out

        _wrap_run(self.server, alter)
