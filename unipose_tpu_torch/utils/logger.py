"""TSV metric logger (Reference: utils/extra_utils/logger.py:24-99 — the
hourglass-style ``Logger`` kept for output parity, without the matplotlib
plotting dependency baked in).

A copy of ``unipose_tpu/utils/logger.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence


class Logger:
    """Append-only TSV logger with named columns; resumable."""

    def __init__(self, fpath: str, title: Optional[str] = None, resume: bool = False):
        self.fpath = fpath
        self.title = title or fpath
        self.names: List[str] = []
        self.numbers: Dict[str, List[float]] = {}
        if resume:
            with open(fpath) as f:
                self.names = f.readline().rstrip().split("\t")
                self.numbers = {n: [] for n in self.names}
                for line in f:
                    vals = line.rstrip().split("\t")
                    for n, v in zip(self.names, vals):
                        self.numbers[n].append(float(v))
            self.file = open(fpath, "a")
        else:
            self.file = open(fpath, "w")

    def set_names(self, names: Sequence[str]) -> None:
        self.names = list(names)
        self.numbers = {n: [] for n in self.names}
        self.file.write("\t".join(self.names) + "\n")
        self.file.flush()

    def append(self, numbers: Sequence[float]) -> None:
        assert len(self.names) == len(numbers), "numbers do not match names"
        self.file.write(
            "\t".join("{0:.6f}".format(float(n)) for n in numbers) + "\n"
        )
        self.file.flush()
        for name, num in zip(self.names, numbers):
            self.numbers[name].append(float(num))

    def close(self) -> None:
        self.file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
