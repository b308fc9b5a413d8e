"""Where a step's count hooks in (the dry run's, ``launch/counting.py``):
its repeated units — the loops over layer groups, loss chunks, Mamba and
mLSTM chunks, sLSTM steps and microbatches — and its kernel calls.

Each such loop iterates over :func:`repeat` and passes the pieces it
gathers through :func:`full` before joining them; a kernel's wrapper
runs its kernel inside :func:`kernel` when :func:`active`. With no
counter installed (every run but a counted one) ``repeat(n)`` is
``range(n)``, ``full`` returns its list and ``active()`` is False: the
step runs as written.

A counter installs itself with :func:`install`. Counting a whole step, it
runs every iteration; counting a multiplied step it runs four (the
first three and the last) and weighs the third by ``n - 3`` (the
reference's HLO walk multiplies a ``while`` body by its trip count), and
:func:`full` stands the last piece in for the iterations not run, so the
code after the loop sees the shapes of the whole run. What an iteration
keeps, the counter reads from its own ledger of live storages
(``counting.Counter.repeat``).
"""
from __future__ import annotations

from typing import List, Optional

_COUNTER = []  # the installed counter, if any


def install(counter) -> None:
    """Route :func:`repeat` and :func:`kernel` through ``counter`` (None:
    plain loops, no count)."""
    _COUNTER[:] = [] if counter is None else [counter]


def active() -> bool:
    """Whether a counter is installed."""
    return bool(_COUNTER)


def repeat(n: int, outs: Optional[list] = None):
    """The iterations of a loop of ``n`` that appends its pieces to
    ``outs``, if it gathers any (module docstring)."""
    if not _COUNTER:
        return range(n)
    return _COUNTER[0].repeat(n, outs)


def full(outs: List, n: int) -> List:
    """``outs`` with its last piece standing in for the iterations a
    multiplied count did not run (detached: the backward of the piece
    that ran weighs for them); ``outs`` itself when all ran."""
    if len(outs) >= n:
        return outs
    return outs + [outs[-1].detach()] * (n - len(outs))


def kernel(name: str, flops: float, nbytes: float, inputs=()):
    """The context of one kernel call under the installed counter (call
    only when :func:`active`): it adds ``flops`` and ``nbytes`` for the
    call, reads ``inputs`` from HBM, and counts none of the operations
    inside (the plain version's, on a CPU tensor)."""
    return _COUNTER[0].kernel(name, flops, nbytes, inputs)
