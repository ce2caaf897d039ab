"""Minimal Praat TextGrid parser (long and short text formats; copy of
artspeech_tpu/data/textgrid.py).

Replaces the reference's external ``tgt`` dependency (database_collector.py:7,
``read_textgrid``). Only what the collectors need: named interval tiers with
(start_time, end_time, text) intervals.
"""

import re
from dataclasses import dataclass, field
from typing import List


@dataclass
class Interval:
    start_time: float
    end_time: float
    text: str


@dataclass
class IntervalTier:
    name: str
    intervals: List[Interval] = field(default_factory=list)

    def __iter__(self):
        return iter(self.intervals)


@dataclass
class TextGrid:
    tiers: List[IntervalTier] = field(default_factory=list)

    def get_tier_by_name(self, name: str) -> IntervalTier:
        for tier in self.tiers:
            if tier.name == name:
                return tier
        raise KeyError(f"No tier named {name!r}")

    def get_tier_names(self) -> List[str]:
        return [tier.name for tier in self.tiers]


_QUOTED = re.compile(r'"((?:[^"]|"")*)"')
_NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")


def read_textgrid(filepath: str) -> TextGrid:
    with open(filepath, encoding="utf-8-sig", errors="replace") as f:
        content = f.read()
    return parse_textgrid(content)


def parse_textgrid(content: str) -> TextGrid:
    """Parse either the long ("item [1]:") or short TextGrid format.

    Strategy: tokenize quoted strings and numbers in order; the structural
    grammar of both formats reduces to the same token stream:
    "ooTextFile" "TextGrid" xmin xmax <exists> size
    then per tier: "IntervalTier" name xmin xmax n (xmin xmax "text") * n
    """
    tokens: List = []
    pos = 0
    while pos < len(content):
        q = _QUOTED.match(content, pos)
        if q:
            tokens.append(("s", q.group(1).replace('""', '"')))
            pos = q.end()
            continue
        n = _NUMBER.match(content, pos)
        if n and (pos == 0 or not (content[pos - 1].isalnum() or content[pos - 1] in "._[")):
            tokens.append(("n", float(n.group(0))))
            pos = n.end()
            continue
        pos += 1

    # Drop the header strings/numbers up to the tier count.
    idx = 0
    def next_of(kind):
        nonlocal idx
        while idx < len(tokens) and tokens[idx][0] != kind:
            idx += 1
        if idx >= len(tokens):
            raise ValueError("Malformed TextGrid")
        value = tokens[idx][1]
        idx += 1
        return value

    # header: "ooTextFile" "TextGrid"
    next_of("s")
    next_of("s")
    next_of("n")  # global xmin
    next_of("n")  # global xmax
    # "<exists>" may appear as a string in short format; tier count is the
    # next number either way.
    n_tiers = int(next_of("n"))

    grid = TextGrid()
    for _ in range(n_tiers):
        tier_class = next_of("s")
        tier_name = next_of("s")
        next_of("n")  # tier xmin
        next_of("n")  # tier xmax
        n_intervals = int(next_of("n"))
        tier = IntervalTier(name=tier_name)
        if tier_class == "IntervalTier":
            for _ in range(n_intervals):
                xmin = next_of("n")
                xmax = next_of("n")
                text = next_of("s")
                tier.intervals.append(Interval(xmin, xmax, text))
        else:  # TextTier / PointTier: (number, mark) pairs; store as zero-width
            for _ in range(n_intervals):
                t = next_of("n")
                mark = next_of("s")
                tier.intervals.append(Interval(t, t, mark))
        grid.tiers.append(tier)
    return grid


def write_textgrid(grid: TextGrid, filepath: str, xmin=0.0, xmax=None):
    """Write a long-format TextGrid (used by the synthetic-corpus fixture and
    the make_sentence_layer tooling)."""
    if xmax is None:
        xmax = max(
            (iv.end_time for tier in grid.tiers for iv in tier.intervals),
            default=0.0,
        )
    lines = [
        'File type = "ooTextFile"',
        'Object class = "TextGrid"',
        "",
        f"xmin = {xmin}",
        f"xmax = {xmax}",
        "tiers? <exists>",
        f"size = {len(grid.tiers)}",
        "item []:",
    ]
    for t, tier in enumerate(grid.tiers, start=1):
        lines += [
            f"    item [{t}]:",
            '        class = "IntervalTier"',
            f'        name = "{tier.name}"',
            f"        xmin = {xmin}",
            f"        xmax = {xmax}",
            f"        intervals: size = {len(tier.intervals)}",
        ]
        for i, iv in enumerate(tier.intervals, start=1):
            lines += [
                f"        intervals [{i}]:",
                f"            xmin = {iv.start_time}",
                f"            xmax = {iv.end_time}",
                f'            text = "{iv.text}"',
            ]
    with open(filepath, "w") as f:
        f.write("\n".join(lines) + "\n")
