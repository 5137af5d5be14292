"""Out-of-place indexed reads and writes that never read back to the host.

The JAX package's functional updates `x.at[i].set(v, mode="drop")` and
`.at[i].add(v, mode="drop")` copy `x` and silently drop an index that
is out of range; its callers use the index len(x) as "write nowhere".
Here the write goes into a copy one slot longer, and the extra slot
(the sentinel) is cut off. Indexing with a 0-d tensor would turn the
index into a Python number, a host read; `take` indexes with a
one-element tensor instead. Python numbers are written with fills, so
no constant is copied from the host.
"""

from __future__ import annotations

import torch


def _padded(x: torch.Tensor, fill) -> torch.Tensor:
    """A copy of x with one more slot along dim 0 holding `fill`."""
    out = x.new_full((x.shape[0] + 1,) + tuple(x.shape[1:]), fill)
    out[:-1] = x
    return out


def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor i (a view-free gather)."""
    return x.index_select(0, i.reshape(1).to(torch.int64))[0]


def last_wins(idx: torch.Tensor, n: int) -> torch.Tensor:
    """idx (int64, values in [0, n]) with every write to a slot but the
    last redirected to the sentinel n. XLA leaves the winner of repeated
    scatter indices unspecified (its CPU scatter, like numpy, keeps the
    last write) and so does torch on the card; with this the port keeps
    the last write on every device."""
    pos = torch.arange(idx.numel(), device=idx.device).view(idx.shape)
    last = torch.full((n + 1,), -1, dtype=torch.int64, device=idx.device)
    last.scatter_reduce_(0, idx.reshape(-1), pos.reshape(-1), "amax")
    return torch.where(last[idx] == pos, idx, n)


def put(x: torch.Tensor, idx: torch.Tensor, v) -> torch.Tensor:
    """Copy of x with x[idx] = v along dim 0; idx == len(x) is dropped.
    Where idx repeats, the last write wins (`last_wins`)."""
    out = _padded(x, 0)
    idx = idx.to(torch.int64)
    if torch.is_tensor(v):
        out[last_wins(idx, x.shape[0])] = v
    else:  # one value for all: no winner to pick, no host-to-device copy
        out.index_fill_(0, idx.reshape(-1), v)
    return out[:-1]


def put_add(x: torch.Tensor, idx: torch.Tensor, v) -> torch.Tensor:
    """Copy of x with v added at idx along dim 0 (repeats accumulate);
    idx == len(x) is dropped."""
    idx = idx.to(torch.int64)
    if not torch.is_tensor(v):
        v = torch.full(idx.shape + x.shape[1:], v, dtype=x.dtype, device=x.device)
    return _padded(x, 0).index_add_(0, idx, v.to(x.dtype))[:-1]


def put_row(x: torch.Tensor, i: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """Copy of x with x[i] = row for a 0-d index tensor i < len(x)."""
    out = x.clone()
    out[i.reshape(1).to(torch.int64)] = row.unsqueeze(0)
    return out


def select(cond: torch.Tensor, a, b):
    """Field by field torch.where(cond, a, b) over two NamedTuples of
    tensors; a field that is the same tensor in both is passed through."""
    return type(a)(*[x if x is y else torch.where(cond, x, y) for x, y in zip(a, b)])
