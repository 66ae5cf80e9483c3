"""What the readers of the program's own spans share, beside
``readers.host_ms``: how many spans of one name start inside the traced
window, per traced step or image (``host_syncs.*``: the program's
``cim.sync`` spans, one at each point where the host waits for the card).

A program without such spans (an older commit) gives None, as a run off
the card or of the other kind does: a step always reads its metrics and
an evaluation window its scores, so a trace with no span of the name is a
program that does not record it.
"""
from __future__ import annotations

from benchmark.readers import _window


def spans_per_step(rec, kind: str, name: str) -> float | None:
    """Spans named ``name`` that start inside the traced window, over the
    traced steps (or images)."""
    win = _window(rec, kind)
    if win is None or not rec["steps"]:
        return None
    lo, hi = win
    n = sum(lo <= s <= hi for s, _ in rec["trace"].spans(name))
    return n / rec["steps"] if n else None
