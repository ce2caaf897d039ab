"""TextGrid surgery: split long silences and rebuild sentence tiers (copy of
artspeech_tpu/data/sentence_layer.py over the port's own data/textgrid.py).

Equivalent of reference scripts/make_sentence_layer.py:10-233: merge
consecutive identical intervals, split silences longer than a threshold into
SIL / EMPTY / SIL thirds, and derive Short/Long sentence tiers by grouping
words between EMPTY gaps.
"""

from typing import List, Optional

from artspeech_tpu_torch.data.textgrid import Interval, IntervalTier, TextGrid

EMPTY = ""
SIL = "#"
LONG_SIL_MAX_LENGTH = 1.5
SHORT_SIL_MAX_LENGTH = 0.6


def merge_same_intervals(tier: IntervalTier) -> IntervalTier:
    """Merge consecutive intervals with identical text (tgt
    ``get_copy_with_same_intervals_merged`` equivalent)."""
    merged: List[Interval] = []
    for interval in tier.intervals:
        if merged and merged[-1].text == interval.text:
            merged[-1] = Interval(
                start_time=merged[-1].start_time,
                end_time=interval.end_time,
                text=merged[-1].text,
            )
        else:
            merged.append(interval)
    return IntervalTier(name=tier.name, intervals=merged)


def split_long_silences(
    tier: IntervalTier, max_length: float, name: Optional[str] = None
) -> IntervalTier:
    """Split interior SIL intervals longer than ``max_length`` into
    SIL / EMPTY / SIL thirds (reference :55-90)."""
    out: List[Interval] = []
    intervals = tier.intervals
    for i, interval in enumerate(intervals):
        is_edge = i == 0 or i == len(intervals) - 1
        length = interval.end_time - interval.start_time
        if is_edge or interval.text != SIL or length <= max_length:
            out.append(interval)
            continue
        third = length / 3
        out.append(Interval(interval.start_time, interval.start_time + third, SIL))
        out.append(
            Interval(
                interval.start_time + third,
                interval.start_time + 2 * third,
                EMPTY,
            )
        )
        out.append(Interval(interval.start_time + 2 * third, interval.end_time, SIL))
    return IntervalTier(name=name or tier.name, intervals=out)


def sentences_from_words(word_tier: IntervalTier, name: str) -> IntervalTier:
    """Group word intervals between EMPTY gaps into sentence intervals whose
    text joins the non-SIL words (reference :158-216)."""
    out: List[Interval] = []
    group: List[Interval] = []

    def flush():
        if group:
            text = " ".join(iv.text for iv in group if iv.text != SIL).strip()
            out.append(Interval(group[0].start_time, group[-1].end_time, text))
            group.clear()

    for interval in word_tier.intervals:
        if interval.text == EMPTY:
            flush()
            out.append(interval)
        else:
            group.append(interval)
    flush()
    return IntervalTier(name=name, intervals=out)


def make_sentence_layers(grid: TextGrid) -> TextGrid:
    """Full pipeline: returns a new TextGrid with LongSentenceTier,
    ShortSentenceTier, WordTier (short-split) and PhonTier (short-split)."""
    word_tier = merge_same_intervals(grid.get_tier_by_name("WordTier"))
    phon_tier = merge_same_intervals(grid.get_tier_by_name("PhonTier"))

    short_words = split_long_silences(word_tier, SHORT_SIL_MAX_LENGTH, "WordTier")
    long_words = split_long_silences(word_tier, LONG_SIL_MAX_LENGTH, "LongWordTier")
    short_phones = split_long_silences(phon_tier, SHORT_SIL_MAX_LENGTH, "PhonTier")

    return TextGrid(
        tiers=[
            sentences_from_words(long_words, "LongSentenceTier"),
            sentences_from_words(short_words, "ShortSentenceTier"),
            short_words,
            short_phones,
        ]
    )
