"""Results tables (counterpart of the curses PrintTable,
``eval/utils/print_table.py:7-110``).

Two surfaces: ``print_results_table`` renders the final plain-text table
(same rows/columns as the reference's), and ``LiveTable`` updates hit
rates in place WHILE the evaluation runs — with curses when stdout is a
real terminal (the reference's behavior), degrading to a rolling
single-line progress print when it isn't (pipes, logs, CI), where a
curses takeover would garble the output."""
from __future__ import annotations

import sys
from typing import Sequence

import numpy as np

ROW_NAMES = ("Top1 exact", "Top1 near", "Top3 exact", "Top10 exact")


def format_results_table(seq_lens: Sequence[int], rates: np.ndarray,
                         ms_per_query: float) -> str:
    secs = [(int(s) + 1) / 2.0 for s in seq_lens]  # segments -> seconds
    head = "  ".join(f"{s:>6}" for s in seq_lens)
    sec_row = "  ".join(f"{s:>5.1f}s" for s in secs)
    lines = [
        "=" * (14 + 8 * len(seq_lens)),
        f"{'segments':>12}  {head}",
        f"{'duration':>12}  {sec_row}",
        "-" * (14 + 8 * len(seq_lens)),
    ]
    for name, row in zip(ROW_NAMES, np.asarray(rates)):
        cells = "  ".join(f"{v:>6.2f}" for v in row)
        lines.append(f"{name:>12}  {cells}")
    lines.append("-" * (14 + 8 * len(seq_lens)))
    lines.append(f"avg search time: {ms_per_query:.2f} ms/query")
    lines.append("=" * (14 + 8 * len(seq_lens)))
    return "\n".join(lines)


def print_results_table(seq_lens, rates, ms_per_query: float) -> None:
    print(format_results_table(seq_lens, rates, ms_per_query))


class LiveTable:
    """In-place hit-rate display during evaluation.

    ``update(si, rates_col, done, total, ms)`` refreshes column ``si``
    with the 4 running hit rates. Curses mode redraws the whole table;
    fallback mode prints a rolling progress line (overwritten with
    ``\\r``). Always ``close()`` (or use as a context manager) so the
    terminal is restored.
    """

    def __init__(self, seq_lens: Sequence[int], use_curses: bool = None):
        self.seq_lens = list(seq_lens)
        self.rates = np.zeros((4, len(self.seq_lens)))
        self._scr = None
        if use_curses is None:
            use_curses = sys.stdout.isatty()
        if use_curses:
            try:
                import curses
                self._curses = curses
                self._scr = curses.initscr()
                curses.noecho()
                curses.cbreak()
            except Exception:
                self._scr = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def update(self, si: int, rates_col, done: int, total: int,
               ms_per_query: float) -> None:
        self.rates[:, si] = rates_col
        status = (f"seq_len {self.seq_lens[si]}: {done}/{total}  "
                  f"top1 {self.rates[0, si]:5.1f}%  "
                  f"{ms_per_query:6.2f} ms/query")
        if self._scr is not None:
            try:
                self._scr.erase()
                text = format_results_table(self.seq_lens, self.rates,
                                            ms_per_query)
                for i, line in enumerate(text.split("\n")):
                    self._scr.addstr(i, 0, line)
                self._scr.addstr(i + 1, 0, status)
                self._scr.refresh()
                return
            except Exception:
                pass  # terminal too small etc. — fall through to plain
        print(f"  {status}", end="\r")

    def line_break(self) -> None:
        """End the rolling line (no-op under curses)."""
        if self._scr is None:
            print()

    def close(self) -> None:
        if self._scr is not None:
            try:
                self._curses.nocbreak()
                self._curses.echo()
                self._curses.endwin()
            finally:
                self._scr = None
