"""Synthetic tiny-corpus fixture generator (copy of
artspeech_tpu/data/synthetic_corpus.py: the same arguments and seed write
byte-identical files).

Creates a miniature corpus on disk with the exact directory schema the
collectors and datasets expect (inference_contours/*.npy, *.textgrid, *.wav),
so the full data -> model -> eval pipeline can be integration-tested without
real MRI data. The reference has no equivalent (it has no tests at all,
SURVEY.md section 4); this fills that gap.
"""

import os
from typing import Sequence

import numpy as np

from artspeech_tpu_torch.core.constants import TUBE_ARTICULATORS
from artspeech_tpu_torch.data.audio import write_wav
from artspeech_tpu_torch.data.textgrid import Interval, IntervalTier, TextGrid, write_textgrid

DEFAULT_PHONEMES = ["#", "a", "b", "i", "p", "t", "u"]


def make_vcv_corpus(
    root: str,
    consonants: Sequence[str] = ("p", "t", "b"),
    vowel: str = "a",
    stretches: Sequence[int] = (0, 20, 40, 60),
    framerate: int = 50,
) -> dict:
    """Write a VCV (vowel-consonant-vowel) stimulus corpus: TextGrids only.

    One "subject" per stretch factor (``stretched{N}pct``, consonant
    duration scaled by 1+N/100) with one sequence per consonant, laid out
    as ``{root}/{subject}/{seq}/{seq}.textgrid`` — the schema the
    ``textgrid_only`` collector walks (reference
    database_collector.py:223-290 and thesis_config
    generate_vcv_{model_free,autoencoder}.yaml).
    """
    info = {"root": root, "sentences": []}
    for stretch in stretches:
        subject = f"stretched{stretch}pct"
        factor = 1.0 + stretch / 100.0
        for i, consonant in enumerate(consonants):
            sequence = f"VCV{i + 1:02d}"
            seq_dir = os.path.join(root, subject, sequence)
            os.makedirs(seq_dir, exist_ok=True)

            sil, v_dur = 0.2, 0.2
            c_dur = 0.12 * factor
            phones = [
                ("#", sil),
                (vowel, v_dur),
                (consonant, c_dur),
                (vowel, v_dur),
                ("#", sil),
            ]
            phon_tier = IntervalTier("PhonTier")
            t0 = 0.0
            for text, dur in phones:
                phon_tier.intervals.append(Interval(t0, t0 + dur, text))
                t0 += dur
            sent_tier = IntervalTier("SentenceTier")
            sent_tier.intervals.append(Interval(0.0, t0, f"{vowel} {consonant} {vowel}"))
            word_tier = IntervalTier("WordTier")
            word_tier.intervals.append(Interval(0.0, t0, f"{vowel}{consonant}{vowel}"))
            grid = TextGrid(tiers=[sent_tier, word_tier, phon_tier])
            write_textgrid(grid, os.path.join(seq_dir, f"{sequence}.textgrid"), xmax=t0)
            info["sentences"].append(
                {
                    "subject": subject,
                    "sequence": sequence,
                    "phones": [p for p, _ in phones],
                }
            )
    info["phonemes"] = sorted({"#", vowel, *consonants})
    return info


def _contour_for(articulator: str, frame: int, rng) -> np.ndarray:
    """A smooth, articulator-specific wiggly arc in pixel coordinates.

    The tail-clip reference articulators sit at y offsets that satisfy the
    TailClipper keep-conditions (tongue below max lower-incisor y and below
    min epiglottis y + margin, reference tail_clipper.py:13-49), so corpora
    built here survive clip_tails=True paths (e.g. the recognition dataset,
    which hard-codes it) without degenerating to empty contours.
    """
    idx = sorted(TUBE_ARTICULATORS).index(articulator) if articulator in TUBE_ARTICULATORS else 11
    t = np.linspace(0.0, 1.0, 50)
    base_r = 20.0 + 6.0 * idx
    ang = np.pi * (0.2 + 0.6 * t) + 0.02 * frame
    cx, cy = 68.0, 68.0
    y_shift = {"lower-incisor": 40.0, "epiglottis": 60.0}.get(articulator, 0.0)
    x = cx + base_r * np.cos(ang) + 0.5 * np.sin(5 * t + idx)
    y = cy + y_shift + base_r * np.sin(ang) + 0.5 * np.cos(4 * t + frame * 0.1)
    pts = np.stack([x, y], axis=1)
    return (pts + 0.2 * rng.normal(size=pts.shape)).astype(np.float32)


def make_synthetic_corpus(
    root: str,
    subjects: Sequence[str] = ("s1",),
    sequences: Sequence[str] = ("S01",),
    n_sentences: int = 2,
    frames_per_sentence: int = 12,
    framerate: int = 50,
    articulators: Sequence[str] = None,
    phonemes: Sequence[str] = None,
    seed: int = 0,
    database_name: str = "gottingen",
) -> dict:
    """Write a corpus under ``root`` and return its description.

    Layout per (subject, sequence):
        {root}/{subj}/{seq}/inference_contours/{frame:04d}_{articulator}.npy
        {root}/{subj}/{seq}/vol_{subj}_{seq}.wav (gottingen naming)
        {root}/{subj}/{seq}/vol_{subj}_{seq}.textgrid
    """
    rng = np.random.default_rng(seed)
    articulators = list(articulators or sorted(TUBE_ARTICULATORS))
    phonemes = list(phonemes or DEFAULT_PHONEMES)

    info = {"root": root, "sentences": []}
    for subject in subjects:
        for sequence in sequences:
            seq_dir = os.path.join(root, subject, sequence)
            contours_dir = os.path.join(seq_dir, "inference_contours")
            os.makedirs(contours_dir, exist_ok=True)

            total_frames = n_sentences * frames_per_sentence
            duration = total_frames / framerate

            frame_ids = [f"{i:04d}" for i in range(total_frames)]
            for f, frame_id in enumerate(frame_ids):
                for articulator in articulators:
                    np.save(
                        os.path.join(contours_dir, f"{frame_id}_{articulator}.npy"),
                        _contour_for(articulator, f, rng),
                    )

            # Audio: noise of matching duration.
            sr = 16000
            samples = 0.01 * rng.normal(size=int(round(duration * sr))).astype(np.float32)
            if database_name == "gottingen":
                wav_name = f"vol_{subject}_{sequence}.wav"
                tg_name = f"vol_{subject}_{sequence}.textgrid"
            else:
                wav_name = f"{subject}_{sequence}.wav"
                tg_name = f"{subject}_{sequence}_adjusted.textgrid"
            write_wav(os.path.join(seq_dir, wav_name), samples, sr)

            # TextGrid: sentences split evenly, phones split within sentences.
            sent_tier = IntervalTier("SentenceTier")
            phon_tier = IntervalTier("PhonTier")
            word_tier = IntervalTier("WordTier")
            sent_dur = duration / n_sentences
            for s in range(n_sentences):
                s0 = s * sent_dur
                s1 = (s + 1) * sent_dur
                sent_tier.intervals.append(Interval(s0, s1, f"sentence {s}"))
                n_phones = 4
                ph_dur = (s1 - s0) / n_phones
                sent_phones = []
                for p in range(n_phones):
                    text = phonemes[(s * n_phones + p) % len(phonemes)]
                    phon_tier.intervals.append(
                        Interval(s0 + p * ph_dur, s0 + (p + 1) * ph_dur, text)
                    )
                    sent_phones.append(text)
                word_tier.intervals.append(Interval(s0, s1, " ".join(sent_phones)))
                info["sentences"].append(
                    {"subject": subject, "sequence": sequence, "phones": sent_phones}
                )

            grid = TextGrid(tiers=[sent_tier, word_tier, phon_tier])
            write_textgrid(grid, os.path.join(seq_dir, tg_name), xmax=duration)

    info["articulators"] = articulators
    info["phonemes"] = phonemes
    return info
