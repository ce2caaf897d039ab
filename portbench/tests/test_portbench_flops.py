"""The model FLOP counts behind ``mfu.*`` match a count by hand at tiny
widths (2 FLOPs a multiply-add, products only)."""

import pytest
import torch

from portbench.reference import bigru, transformer

ARTS = ["a", "b"]


def test_bigru_hand_count():
    cfg = dict(vocab_size=5, embed_dim=3, hidden_size=2, num_layers=2, dense=2, head_hidden=4,
               n_samples=3, articulators=ARTS)
    # A frame: layer 0, both directions: input 3 x 6, recurrence 2 x 6 -> 2 (18 + 12);
    # layer 1: input 4 x 6, recurrence 2 x 6 -> 2 (24 + 12); Dense 4 x 2 = 8;
    # two heads: 2 x 4 + 4 x 4 + 4 x 3 + 4 x 3 = 48 each. Multiply-adds: 236.
    per_frame = 2 * (2 * (18 + 12) + 2 * (24 + 12) + 8 + 2 * 48)
    assert bigru.forward_flops(cfg, [7, 5]) == per_frame * 12 == 472 * 12


def test_bigru_count_matches_the_programs_products():
    from torch.utils.flop_counter import FlopCounterMode
    from artspeech_tpu_torch.models.artspeech_rnn import ArtSpeech
    cfg = dict(vocab_size=5, embed_dim=3, hidden_size=2, num_layers=2, dense=2, head_hidden=256,
               n_samples=3, articulators=ARTS)
    model = ArtSpeech(5, 2, embed_dim=3, hidden_size=2, n_samples=3, device="cpu")
    tokens = torch.zeros(2, 6, dtype=torch.long)
    with FlopCounterMode(display=False) as counter:
        model(tokens, torch.tensor([6, 6]))
    assert counter.get_total_flops() == bigru.forward_flops(cfg, [6, 6])


def test_transformer_hand_count():
    cfg = dict(vocab_size=5, embed_dim=4, num_heads=2, encoder_ff_dim=8, num_feat=6,
               num_layers=1, head_hidden=4, articulators=["a", "b", "c"])
    # Multiply-adds a frame: a Q/K/V-MLP attention block 7 E^2 = 112; encoder
    # 4 E^2 + 2 E FF = 128; decoder: 3 self + 6 pair + 3 memory blocks, the
    # pairs' projection 6 E^2 = 96, the feed-forward 3 E^2 = 48 -> 1,488;
    # head: target embedding 3 x 6 x 4 = 72, Dense 12 x 4 = 48, three contour
    # heads 4 x 4 + 4 x 4 + 2 x 4 x 3 = 56 each -> 288. Total 1,904.
    # Attention (query, key) pairs: n^2 encoder + 3 causal + 6 causal + 3 n^2
    # memory: n = 2 -> 4 + 9 + 18 + 12 = 43; n = 3 -> 9 + 18 + 36 + 27 = 90;
    # each pair 2 E multiply-adds.
    want = 2 * (2 * 1904 + 8 * 43) + 2 * (3 * 1904 + 8 * 90)
    assert transformer.forward_flops(cfg, [2, 3]) == want == 21168
