"""repro_torch.distributed — the sharding layer (``sharding``, ``params``)
and the train, prefill and serve step factories (``steps``).

The step factories are loaded on first use: the model imports
``sharding``, and ``steps`` imports the model."""

__all__ = ["make_prefill_step", "make_serve_step", "make_train_step"]


def __getattr__(name):
    if name in __all__:
        from . import steps
        return getattr(steps, name)
    raise AttributeError(name)
