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

from typing import NamedTuple

import torch

# `segments` spreads the rows that add nothing over this many segments
# past the real ones, so that none of them is long: a segment is summed
# by one thread per output element
_SPREAD = 4096


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


class Segments(NamedTuple):
    """An index's rows in a fixed order for `segment_sum`: their stable
    sort by slot, and the rows of each slot."""

    order: torch.Tensor  # [O] int64
    lengths: torch.Tensor  # [n + _SPREAD] int64


def segments(n: int, idx: torch.Tensor, live: torch.Tensor) -> Segments:
    """The Segments of idx over n slots, where the rows that are not
    `live` add zeros (they go to spare segments past n). No host read."""
    spare = n + torch.arange(idx.numel(), device=idx.device) % _SPREAD
    key = torch.where(live, idx, spare)
    lengths = torch.zeros(n + _SPREAD, dtype=torch.int64, device=idx.device)
    lengths.index_add_(0, key, torch.ones_like(key))  # integer adds: exact
    return Segments(torch.argsort(key, stable=True), lengths)


def segment_sum(n: int, idx: torch.Tensor, v: torch.Tensor,
                seg: Segments | None = None) -> torch.Tensor:
    """zeros(n, ...) with the rows of v added at idx (repeats accumulate;
    every idx < n): the JAX package's `jnp.zeros(...).at[idx].add(v)`.

    Given `seg` (`segments(n, idx, live)`, v zero where not live), each
    slot sums its rows in sorted order, on the card one thread per output
    element: the same sum on every call, where index_add_'s atomics on
    the card sum in another order each time. Without it index_add_, on
    the CPU a sequential sum."""
    if seg is not None:
        return torch.segment_reduce(v[seg.order], "sum", lengths=seg.lengths, axis=0,
                                    unsafe=True)[:n]
    return v.new_zeros((n,) + v.shape[1:]).index_add_(0, idx, v)


def put_row(x: torch.Tensor, i: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """Copy of x with x[i] = row for a 0-d index tensor i < len(x)."""
    out = x.clone()
    out[i.reshape(1).to(torch.int64)] = row.unsqueeze(0)
    return out


def select(cond: torch.Tensor, a, b):
    """Field by field torch.where(cond, a, b) over two NamedTuples of
    tensors; a field that is the same tensor in both is passed through."""
    return type(a)(*[x if x is y else torch.where(cond, x, y) for x, y in zip(a, b)])
