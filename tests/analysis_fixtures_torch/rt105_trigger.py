"""Must trigger RT105: mutable default arguments."""
import torch


def collect(item, acc=[]):
    acc.append(item)
    return acc


def configure(overrides={}, seen=set()):
    return dict(base=torch.zeros(1), **overrides), seen
