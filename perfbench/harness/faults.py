"""The faults a training step can have, planted in the port to read what
they do to the check (the tests, ``calibrate.py``): each a picklable
callable that returns a context manager, to be entered on every rank
(``ranks.planted``)."""

from __future__ import annotations

import contextlib

PACKAGE = "constructionsceneposeestimation_tpu_torch"


@contextlib.contextmanager
def patched(cls, name: str, wrap):
    """``cls.name`` replaced by ``wrap(cls.name)`` inside the block."""
    fn = getattr(cls, name)
    setattr(cls, name, wrap(fn))
    try:
        yield
    finally:
        setattr(cls, name, fn)


def _loop():
    import importlib

    return importlib.import_module(f"{PACKAGE}.train.loop")


def state_unchanged():
    """A step that returns its state unchanged: no update is made."""
    return patched(_loop().BatchStep, "update", lambda fn: lambda self, state: state)


def _half(fn):
    def loss(self, model, images, targets):
        h = images.shape[0] // 2
        return fn(self, model, images[:h], targets[:h])
    return loss


def half_batch():
    """Half of each rank's rows left out, the loss taken over the rest."""
    stack = contextlib.ExitStack()
    loop = _loop()
    stack.enter_context(patched(loop.BatchStep, "loss", _half))
    stack.enter_context(patched(loop.ShardedBatchStep, "loss", _half))
    return stack


def _inverted_rgb(fn):
    def render(self, *a, **kw):
        b = fn(self, *a, **kw)
        return b._replace(rgb=255 - b.rgb)
    return render


def rgb_altered():
    """Every frame's RGB altered where it is produced."""
    from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline

    return patched(Pipeline, "render", _inverted_rgb)


def _unsynced(fn):
    def forward_backward(self, state, batch, draws):
        with state.model.no_sync():
            return fn(self, state, batch, draws)
    return forward_backward


def no_sync():
    """The exchange between the cards left out: DDP's ``no_sync``, so each
    rank updates from its own rows' gradient."""
    return patched(_loop().ShardedBatchStep, "forward_backward", _unsynced)


def _first_rows(fn):
    def batch_sharding(mesh, batch):
        return range(0, len(fn(mesh, batch)))
    return batch_sharding


def one_shard():
    """Every rank generating and training rank 0's rows."""
    from constructionsceneposeestimation_tpu_torch.parallel import mesh

    return patched(mesh, "batch_sharding", _first_rows)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "rgb_altered": rgb_altered, "no_sync": no_sync, "one_shard": one_shard}
