"""Stage timing / profiling UX.

The reference examples wrap each stage with ad-hoc ``time.time()`` prints
("(1) Generating box complete (4.245 sec)", SURVEY.md §5.1).  This module
provides that UX as a context manager, plus an optional hook into
``jax.profiler`` trace annotations so stages show up in device profiles.
"""
from __future__ import annotations

import contextlib
import time

import jax

__all__ = ["stage", "Timings"]


class Timings:
    """Collects named stage durations; printable report."""

    def __init__(self):
        self.records: list[tuple[str, float]] = []

    def add(self, name: str, dt: float):
        self.records.append((name, dt))

    def report(self) -> str:
        lines = ["Stage timings:"]
        for name, dt in self.records:
            lines.append(f"  {name:<40s} {dt:8.3f} sec")
        total = sum(dt for _, dt in self.records)
        lines.append(f"  {'TOTAL':<40s} {total:8.3f} sec")
        return "\n".join(lines)


@contextlib.contextmanager
def stage(name: str, verbose: bool = True, timings: Timings | None = None,
          sync=None):
    """Time a pipeline stage, reproducing the reference examples' print style.

    Parameters:
        name: stage label, e.g. "(1) Generating box".
        verbose: print "<name>..." / "<name> complete (x sec)".
        timings: optional Timings collector.
        sync: optional array/pytree to block_until_ready on before stopping
            the clock (device work is async!).
    """
    if verbose:
        print(f"{name}...")
    t0 = time.time()
    with jax.profiler.TraceAnnotation(name):
        holder = {}
        yield holder
    out = holder.get("sync", sync)
    if out is not None:
        jax.block_until_ready(out)
    dt = time.time() - t0
    if verbose:
        print(f"\t{name} complete ({dt:3.3f} sec)")
    if timings is not None:
        timings.add(name, dt)
