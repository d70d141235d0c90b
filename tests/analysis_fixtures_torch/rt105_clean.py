"""Must NOT trigger RT105: immutable defaults / None sentinels."""
import torch


def collect(item, acc=None):
    acc = [] if acc is None else acc
    acc.append(item)
    return acc


def configure(overrides=(), name="default", dtype=torch.float32):
    return dict(base=torch.zeros(1, dtype=dtype), name=name, **dict(overrides))
