"""Drive the PyTorch/CUDA port's synthesis and training paths, the thesis
workflow through its CLIs, the transformer's KV-cached decode and its
training, the autoencoder-based method (phonemes -> principal
components), the mean-contour baseline, the phoneme recognizer (on recorded
and synthesized corpora, and frozen inside the two trainers' losses) and the
bf16 and fp16 compute dtypes on one NVIDIA GPU, and check them.

Usage, from the root of the repository, on a machine with one H100:

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device  — requires CUDA; prints the card's name and power limit;
  2. build   — compiles the nine kernel libraries,
               ops/csrc/{gru_fwd,gru_bwd,p2cp,min_dist,flash_decode,
               train_attention,lstm_fwd,lstm_bwd,gru_seq}.cu, one nvcc each,
               all started together; prints -Xptxas -v's registers and
               spills of each kernel of each library;
  3. kernel  — holds each kernel against its plain PyTorch version on the
               card: the GRU forward and backward at (T, B, H) = (128, 16,
               128) and (128, 256, 128), both directions in one launch and
               each alone, ragged lengths, f32, bf16 and f16 (the backward also
               against torch.autograd through the plain forward); the
               forward also at GRU_FWD_CASES (B = 1, B not a multiple of the
               cluster's rows, T = 1, H = 136, 20 and 6 whose units a CTA are
               not a multiple of 4, B = 64), with a row of length 1, each
               with its launch geometry (cluster size, rows); both also
               one direction at the recognizer's shapes (RECOGNIZER_GRU_CASES:
               T 512 and 256, B = 4, H = 64) with rows of length T, 1 and 0
               (a length-0 row's outputs and gradients exactly zero); P2CP at
               P2CP_CASES (R = 12*128*10 and 1001 at 50 x 50, 37 x 61,
               400 x 300, 7 x 5) and on rows with a NaN coordinate: NaN in
               exactly the plain version's rows, elsewhere within 1e-5, a
               second launch the same bits, each with its tile; min-distance
               through the single entry at the four tract-variable shapes
               with R = 12*128 and R = 1001 rows, at 50 x 51 and 64 x 64 (the
               tile for any shape), on ties (duplicated points, identical
               contours, a permutation) and on TBCD's strided views:
               indices equal, distances within 1e-6
               relative; then one launch for a stack's four tract variables
               (tract_variables_from_stack on seeded (R, 11, 2, 50) stacks,
               R = 12*128 and 1001, with built-in ties, a NaN point, and in
               bf16 and f16) against the plain TV route: values within 1e-6
               relative with NaN at the same places, both places of
               constriction the same bits, one launch a stack, a second
               launch the same bits; flash decode
               at hd = 16 over 128-row caches, G of the self and cross-channel
               caches at B = 1, 12 and 64 and G 4,321 and 4,330 (not a
               multiple of 32 or 64), n_rows 1, 2, 33, 127 and 128, f32, bf16
               and f16 caches, within 1e-5 relative + 2e-5 absolute, each with
               its launch geometry, and a second launch bit for bit; the training
               attention forward and backward (train_attention.cu) at hd = 16,
               G = 360, 4,320 and 23,040 (B = 1, 12, 64 of the thesis
               transformer) with L 32 and 128, L 512, 37 and the buckets past
               512 (576, the loader's for a 530-frame sentence, and 1,024:
               the streamed kernels) at G = 360, and the streamed kernels
               at (hd, L) (64, 128), (64, 576), (128, 128), (128, 576),
               (33, 65), (16, 513) and (16, 577) at G = 360, each with the
               all-ones and a seeded dropout keep mask, and L 1, 16, 33, 65,
               129 and 255 at G = 360 with the dropout keep (the edges of the
               backward's query strips): the forward within 2e-5, dQ/dK/dV
               within 1e-4 * max(|ref|, 1) from the forward kernel's out and
               lse, the forward (out and lse) and the backward the same bits
               on a second launch, each with both launch geometries; the
               LSTM forward and
               backward (lstm_fwd.cu, lstm_bwd.cu) at H 16, 64 and 128, B 1,
               3, 12, 16 and 64, T 1, 7 and 128 (LSTM_CASES), both directions
               in one launch and each alone,
               ragged lengths with a full row and a row of length 1, f32,
               bf16 and f16, held as the GRU kernels are (the forward's cell states
               relative to max(|c|, 1)), each with both launch geometries
               and a second launch bit for bit;
     gru_seq — the batch-major GRU (gru_seq.cu, row 7) against its plain
               version in f32 within 1e-5 (GRU_SEQ_CASES: B = 1, B not a
               multiple of the tile or the cluster's rows, ragged rows of
               length T and 1, T = 1, the cluster step at H 16, 20, 128, 136
               and 256, the wide instance at 512), and batch tile 33 with a
               bf16 x_proj (cast to f32, as JAX does); H above 1,024 refused;
               then its path (a measured reference, as in JAX): one call each
               at B = 16 and 256, T = 128, H = 128, with exactly one launch
               each;
     widths  — every widened kernel against its plain version at widths the
               resident kernels refuse, at the same limits: the GRU forward
               and backward at H 6, 130, 256, 512 and 1,024 in f32, bf16 and
               f16, the LSTM at H 168, 256, 512 and 1,024, the training
               attention at hd 48, 64 and 128 with L 37, 128 and 512, at
               (hd, L) (16, 513) and (48, 600), and at hd 8, 17 and 32 with
               L 128 and 512 (the geometries, "stream:" where the streamed
               kernels run; the forward's out and lse and
               the backward the same bits on a second launch), the decode at
               hd 80, 128 and 256 (f32, bf16 and f16 caches); the
               instance each width takes (the thesis widths keep
               the resident kernels; the forwards' cluster step or wide
               instance as GRU_FWD_INSTANCE and LSTM_FWD_INSTANCE say), the
               outer bounds refused (H 1,025, hd 129, decode hd 257),
               and one timing of each wide instance beside the same PyTorch
               call (cuDNN's GRU and LSTM, the decode's
               scaled_dot_product_attention; the streamed training
               attention's at hd 64 and 128 are in timing) at
               its shape, and the recurrences' cluster steps at H 256 beside
               cuDNN there;
  4. main    — the full-width ArtSpeech (vocab 64, hidden 128) synthesis path:
               synthesize_corpus over 32 seeded sentences into a temporary
               directory, then the bench.py shape (B=16, T=128, 11
               articulators) through make_synthesis_step and
               tube_area_function on the semipolar grid; checks the files,
               finiteness, the kernel launch count, and agreement with the
               same path run on the CPU on a small input;
  5. train   — the thesis trainer (configs/model_free/train_model_free.yaml:
               batch 12, dropout 0.1, AdamW lr 1e-4 wd 1e-5, 10 articulators)
               at full width: ``fit`` for 2 epochs over a seeded in-memory
               corpus (48 train, 12 valid sentences), its checkpoints, a
               resume, the launch counts of all three kernels, 20 steps on one
               batch at lr 1e-3 (the loss must fall), and one train step on
               the card against the same step on the CPU (see
               train_against_cpu for how the updated parameters compare);
  parallel   — data parallelism (parallel/) at train_model_free.yaml's
               widths (B = 12, H = 128, T = 128, ragged, the last 3 rows
               dummies of length 0): a one-rank NCCL group, whose mesh step
               must equal the group-free step after 3 updates (dropout 0.1,
               within 1e-6) with the same gru_fwd, gru_bwd and p2cp launches,
               both steps timed in turns and the all-reduce alone (its share
               of the step); two gloo ranks sharing cuda:0 at dropout 0,
               whose loss and p2cp_mm (1e-4 relative) and parameters after 2
               updates (1e-5, where |g| >= 100 eps as in train_against_cpu)
               must equal the one-rank step's, and the first step's summed
               gradients too (1e-5 max(|g|, 1)), with the kernels launched in
               both ranks; in the same two ranks, the model axis: the
               train_transformer.yaml transformer at full width (dropout 0.1,
               B = 12, T = 128) on a (data 1, model 2) mesh, each rank holding
               5 of the 10 channels of every channel stack and head, 3
               updates against the one-device step on the card (bounds in
               model_axis_against_one_device), each rank's training-attention
               launches at G = 2,160, n_pairs = 45 and their geometry, and
               fit of the thesis model for one epoch on that mesh, whose
               whole checkpoint loads into a one-device model and gives the
               ranks' valid metrics; the reference ArtSpeech import
               (convert_artspeech_state_dict) at the thesis widths, its model
               on the card against the CPU within 1e-5 with its gru_fwd
               launches; and dryrun_multichip(2, backend="gloo"), one step of
               every family over a (1, 2) mesh of two ranks on the card;
  6. cli     — the thesis workflow through the port's three CLIs, each run
               in-process through its run_experiment with sys.argv set, from
               YAML files written from the text of the repository's
               configs/model_free/ configs (only the corpus paths, the
               database, num_epochs: 2, state_dict_filepath and save_to
               changed) over a seeded gottingen-layout corpus on disk (one
               subject, S01-S05, 3 sentences of about 75 frames each):
               train_phoneme_to_articulation (fit + the final test with tract
               variables), test_phoneme_to_articulation on best/state,
               generate_vocal_tract_shape on S05 and, from best_model, on a
               VCV corpus (textgrid_only). Checks the artifact trees, one TV
               CSV row per test frame, finiteness, every kernel's launches on
               each CLI, and the test CLI's results against the train CLI's
               final test; then one test batch through the test step on the
               card against the CPU; then the transformer train CLI from
               configs/model_free/train_transformer.yaml (corpus paths,
               database and num_epochs: 2 changed: fit with the training
               attention kernels, then its autoregressive final test) and
               last the transformer test CLI from the same config
               (state_dict_filepath: the train run's best/state, and
               save_to added) on S05 at the card's generate batch (64) with
               bf16 caches: launches, artifacts, TV CSVs; then the bf16
               configs, train_model_free_bf16.yaml and
               train_transformer_bf16.yaml (num_epochs: 2 and the same
               path edits), and the same two again with compute_dtype:
               float16 (the transformer's final test with
               generate_cache_dtype: float16 added), with the f32 runs'
               launches, and each 16-bit model's forward on the card
               against the CPU's forward in its dtype (half_against_cpu; the
               fp16 ones on the test batch's first sentence);
  7. pc      — the autoencoder-based method through its nine CLI runs over
               the same corpus, from YAML files written from the text of
               configs/autoencoder_based/ (only paths, the database,
               num_epochs: 2, state-dict paths and, for the LSTM model,
               model_kwargs.rnn / model_params.rnn changed):
               calculate_normalization_statistics, train_articulatory_pca,
               train and test_principal_components_autoencoder, then
               train_phoneme_to_principal_components three times (the AE
               config as it stands, rnn: GRU; the same with rnn: LSTM; the
               PCA-based config), test_phoneme_to_principal_components on the
               LSTM model and generate_vocal_tract_shape with method:
               autoencoder from it. Every kernel's launches on each run
               against counts worked out beforehand from the corpus's
               batches, the files each writes, finiteness, and each test
               CLI's results against its train CLI's final test;
     mean_contour — the mean-contour baseline through its train, test and
               generate CLIs from configs/mean_contour/ over the same corpus:
               the table, the P2CP and min_dist launches of each test step,
               artifacts, finiteness, the test CLI against the train CLI's
               final test;
     recognizer — the DeepSpeech2 phoneme recognizer over the same corpus
               (plus seeded air_column arrays): the six
               configs/phoneme_recognition/train_*.yaml through the port's
               train CLI (corpus paths, the database, voicing_filepath and
               num_epochs changed: 2 for train_acoustic, train_vocal_tract and
               train_vocal_tract_bf16, 1 for the others), then the four
               test_*.yaml that read no sentence wavs through the test CLI on
               those checkpoints: the GRU kernels' launches of each run
               against counts from the corpus's batches, the files each
               writes, finiteness, each test CLI against its train CLI's
               final test; one eval batch at full width on the card against
               the CPU (logits and log-probs within 1e-4, the same greedy
               ids); one train step at dropout 0 and margins 0 on the card
               against the CPU, held to float64 as the transformer's; 10
               steps on one batch with dropout (the loss must fall);
     synthetic — in the same temporary directory: the seven
               test_synthetic_*.yaml through the test CLI with synthetic:
               true, each datadir at the corpus [cli], [pc] or
               [mean_contour] synthesized (SYNTHESIS_DIRS) and the best
               checkpoint of [recognizer]'s train_vocal_tract (or _voicing)
               run: gru_fwd launches = layers x test batches, the artifacts,
               finite PER/WIL, and one voiced synthetic batch through the
               eval step on the card against the CPU; the latent RNN's train
               CLI (train_autoencoder_based.yaml, 1 epoch) with a
               recognizer: block and beta4 0.5: launches, checkpoints, finite
               metrics, the same parameter count as without; both GRU
               kernels at the frozen recognizer's shape (T = 128, B = 12, H =
               64, one direction, f32; the all-ones mask and rows of length
               T, 1, 0) against their plain versions; the ArtSpeech and the
               LSTM latent-RNN train steps with the recognizer frozen in
               their losses at B = 12, T = 128: exact launches, the
               recognizer untouched and outside the optimizer, step ms,
               frames/s and the device breakdown; the ArtSpeech one at
               dropout 0 on the card against the CPU, held to float64; 10
               steps on one batch (the loss must fall);
     surfaces — in the same temporary directory, timed by the port's
               StepTimer: the report CLI (configs/model_free/
               report_model_free.yaml, results_dir and database changed)
               over the [cli] test run's outputs on the card (one p2cp
               launch a sentence) and on the CPU, its four CSVs within 1e-5
               relative; shape_to_air_column over S05 on the card and on the
               CPU, the (2, 2, 100) air columns within 1e-5; the corpus's
               vocal-tract shapes through VocalTractShapeLoader with the
               native prefetch and without it, the same bits, both host
               times; p2cp_distance_mm and the tract variables at B = 12,
               T = 128 through the kernels' autograd path (one p2cp and one
               min_dist launch) against the plain route, values within
               1e-5 and gradients within 1e-4 * max(|ref|, 1);
               make_sentence_layer over the corpus's TextGrids; and the
               generate CLI's save_plots / save_videos over a one-sentence
               corpus: jpgs and an .avi where matplotlib and cv2 import, the
               named RuntimeError where they do not;
  8. decode  — the full-width transformer (train_transformer.yaml: embed 64,
               4 heads, 4 layers, 10 articulators) with seeded weights:
               make_fast_generate at T = 128, B = 12 and 64, f32 and bf16
               caches, with exactly 8 * T flash_decode launches a batch,
               frames/s, the device's busy time and idle share and
               flash_decode's device ms and share of it a batch; the cached
               f32 decode against the buffer re-decode at B = 12 for T in
               {32, 64, 128} (make_auto_generate's band); and the
               card against the CPU: one attend, forward and encode within
               1e-4, a T = 16 decode with f32 caches within 1e-4 per frame;
  9. train_transformer — the same transformer in training (dropout 0.1,
               AdamW lr 1e-4 wd 1e-5) at T = 128: one train step at B = 12
               and 64 with exactly 4 forward and 4 backward train_attention
               launches (one each a decoder layer) and nothing else, step ms,
               frames/s, the device breakdown and peak memory; the same step
               with the pair attention materialised in plain torch (timed,
               not used); an accum_steps sweep at B = 64 (microbatches 64,
               16, 8); 20 steps on one batch (the loss must fall); and
               one step at dropout 0 on the card against the CPU (as the
               ArtSpeech one); then a bucket past 512: the batch
               BucketedLoader makes of two sentences of 530 and 519 frames
               (L = 576, the streamed training-attention kernels), one step at
               dropout 0.1 with exactly 4 + 4 train_attention launches, its
               ms and peak memory, and one at dropout 0 on the card against
               the CPU and float64;
 10. latent_rnn — the latent RNN of train_autoencoder_based.yaml at full
               width (embed 64, hidden 128, latent 35) with rnn: LSTM and
               its composite loss over a seeded frozen autoencoder: one
               train step at T = 128, B = 12 and 64 with exactly 2 + 2 lstm
               launches and nothing else, the synthesis forward (RNN ->
               frozen decoder -> denorm) at B = 16 with exactly 2, each with
               frames/s and the device breakdown; 20 steps on one batch (the
               loss must fall); one step on the card against the CPU, held
               to float64 as the transformer's;
 11. timing  — CUDA-event times of each kernel, its plain version and a
               PyTorch library call that computes the same function (a
               yardstick the port never calls), the bound (P2CP and
               min-distance also by graph_ms, with their share of the bound
               and launch geometry; min-distance at each TV shape through
               the single entry and for one stack's four TVs in one
               launch), synthesis frames/s,
               train frames/s at B=12 and B=256 and test frames/s at B=12
               with the device's idle share and top kernels from
               torch.profiler, and each CLI's wall time; flash decode at the
               decode's own calls: the self and cross-channel caches at B = 12
               and 64, f32 and bf16 (and the sweep with f16 caches at B = 12),
               n_rows 1, 16, 64 and 128, and the 256
               calls of one layer's decode sweep over T = 128, cycling cache
               copies that overflow the L2, each by graph_ms (one CUDA graph
               of the calls: device time without host gaps) and back to back,
               with the wrapper's host us a call, its launch geometry, the
               bound summed over the calls and scaled_dot_product_attention
               over the same calls measured the same two ways (the plain
               version and the profiler's device time at n_rows = 128, cross-
               channel); the training attention forward
               and backward at the B = 12 and B = 64 shapes (L = 128, the
               dropout keep), on the streamed route at B = 2 with L 576 and
               1,024 and at B = 12, L = 128 with hd 64 and 128, the same
               way (graph_ms, back to back, the profiler's device time and
               the share of the bound), against
               scaled_dot_product_attention
               (is_causal, all-ones keep: forward, and forward + backward
               minus forward); both LSTM kernels at T = 128, H = 128, B = 12
               and 64 the same way, against cuDNN's nn.LSTM (forward, and
               forward + backward minus forward); the GRU forward at B = 12,
               16 and 256 (and both GRU kernels at B = 12 in f32, bf16 and
               f16 by graph_ms) and the batch-major GRU at B = 16 and 256 beside
               gru_fwd with one direction on the same work, each with its
               launch geometry (C, rows a cluster, CTAs, waves at one CTA
               an SM) and microseconds a step, its plain
               version and cuDNN's nn.GRU; the GRU forward and backward at the
               recognizer's T = 512, B = 4, H = 64, and at the frozen
               recognizer's T = 128, B = 12, H = 64, one direction (graph_ms,
               back to back, the bound, cuDNN's one-direction nn.GRU
               forward and backward alone); and the recognizer's train step
               at full width (melspec: B = 4, 5.1 s of 16 kHz audio, 319
               frames in the 512 bucket; vocal_tract: B = 4, (2, 500, 256)
               features) with step ms, frames/s and the device breakdown,
               and the CTC loss's forward and backward alone the same way;
               its convolutions at the melspec step's shape (the port's
               unfold and product against the K * K shifted products and
               cuDNN's F.conv2d, each against float64, with its memory).
Then one JSON line of kernel numbers and, last, the device line. Any failure
raises and exits non-zero; without CUDA nothing is printed as a result.
"""

import csv
import glob
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from artspeech_tpu_torch.cli import (
    calculate_normalization_statistics,
    config_file,
    generate_vocal_tract_shape,
    make_sentence_layer,
    report_phoneme_to_articulation,
    shape_to_air_column,
    test_phoneme_to_articulation,
    test_phoneme_to_articulation_transformer,
    test_phoneme_recognition,
    test_phoneme_to_principal_components,
    test_phoneme_wise_mean_contour,
    test_principal_components_autoencoder,
    train_articulatory_pca,
    train_phoneme_recognition,
    train_phoneme_to_articulation,
    train_phoneme_to_articulation_transformer,
    train_phoneme_to_principal_components,
    train_phoneme_wise_mean_contour,
    train_principal_components_autoencoder,
)
from artspeech_tpu_torch.cli.common import model_kwargs_from_cfg, run_experiment
from artspeech_tpu_torch.core.config import DATASET_CONFIG, mm_per_unit
from artspeech_tpu_torch.core.constants import (
    LOWER_LIP,
    RECOGNITION_ARTICULATORS,
    TONGUE,
    TUBE_ARTICULATORS,
    UPPER_INCISOR,
    UPPER_LIP,
)
from artspeech_tpu_torch.core.device import resolve_device
from artspeech_tpu_torch.core.vocab import load_vocabulary
from artspeech_tpu_torch.data import loaders
from artspeech_tpu_torch.data.batching import DEFAULT_BUCKETS, BucketedLoader, pick_bucket
from artspeech_tpu_torch.data.collectors import DATABASE_COLLECTORS
from artspeech_tpu_torch.data.datasets import ArtSpeechDataset
from artspeech_tpu_torch.data.pc_datasets import AutoencoderDataset, PrincipalComponentsDataset
from artspeech_tpu_torch.data.recognition import (
    PhonemeRecognitionDataset,
    RecognitionLoader,
    SyntheticPhonemeRecognitionDataset,
)
from artspeech_tpu_torch.data.synthetic_corpus import make_synthetic_corpus, make_vcv_corpus
from artspeech_tpu_torch.data.textgrid import read_textgrid
from artspeech_tpu_torch.eval.articulation import make_test_step
from artspeech_tpu_torch.geometry import tract_variables
from artspeech_tpu_torch.geometry.area_function import tube_area_function
from artspeech_tpu_torch.geometry.grid import build_semipolar_grid
from artspeech_tpu_torch.losses.autoencoder import make_autoencoder_loss
from artspeech_tpu_torch.models.artspeech_rnn import ArtSpeech
from artspeech_tpu_torch.models.autoencoder import MultiArticulatorAutoencoder, normalize_indices_dict
from artspeech_tpu_torch.models.deepspeech2 import (
    Conv,
    DeepSpeech2,
    frozen_recognizer_fn,
    to_recognizer_layout,
)
from artspeech_tpu_torch.models.latent_rnn import (
    PrincipalComponentsArtSpeech,
    make_latent_rnn_synthesis_forward,
)
from artspeech_tpu_torch.models.transformer import ArtSpeechTransformer, make_fast_generate
from artspeech_tpu_torch.parallel.collectives import all_reduce_flat, gather_leading_slices
from artspeech_tpu_torch.parallel.distributed import (
    distribute_state,
    initialize_multihost,
    run_distributed_step,
)
from artspeech_tpu_torch.parallel.dryrun import dryrun_multichip, free_port, spawn
from artspeech_tpu_torch.parallel.mesh import make_mesh
from artspeech_tpu_torch.ops import (
    _build,
    hopper_attention,
    hopper_gru,
    hopper_lstm,
    hopper_min_dist,
    hopper_p2cp,
    hopper_train_attention,
)
from artspeech_tpu_torch.synth.pipeline import make_synthesis_step, synthesize_corpus
from artspeech_tpu_torch.synth.viz import missing_packages
from artspeech_tpu_torch.train import loop, state
from artspeech_tpu_torch.train.checkpoint import load_params, restore_checkpoint, whole_state_dicts
from artspeech_tpu_torch.utils.torch_import import convert_artspeech_state_dict
from artspeech_tpu_torch.losses import articulation as articulation_losses
from artspeech_tpu_torch.losses.articulation import masked_euclidean_loss, recognition_feature_loss
from artspeech_tpu_torch.losses.recognition import ctc_loss
from artspeech_tpu_torch.train.pc_step import make_latent_rnn_train_step
from artspeech_tpu_torch.train.recognition_step import (
    cyclic_triangular_schedule,
    make_recognition_eval_step,
    make_recognition_train_step,
)
from artspeech_tpu_torch.train.step import (
    make_artspeech_eval_step,
    make_artspeech_train_step,
    make_transformer_train_step,
    shift_targets_right,
)
from artspeech_tpu_torch.utils.io import sequences_from_dict
from artspeech_tpu_torch.utils.profiling import StepTimer

VOCAB, HIDDEN = 64, 128
BENCH_B, BENCH_T = 16, 128
KERNEL_SHAPES = [(128, 16, 128), (128, 256, 128)]  # (T, B, H)
#: gru_fwd beyond KERNEL_SHAPES, (T, B, H): B = 1, B not a multiple of the
#: cluster's rows (13), T = 1, H whose units a CTA (H/C) are not a multiple
#: of 4 (136: C = 8, U = 17; 20: C = 4, U = 5; 6: C = 2, U = 3) and a batch
#: that takes clusters of 2 and 4 (64); every forward case has a row of
#: length T and one of length 1.
GRU_FWD_CASES = [(128, 1, 128), (37, 13, 128), (1, 12, 128), (9, 5, 136), (9, 7, 20), (9, 5, 6),
                 (17, 64, 128)]
#: gru_bwd beyond KERNEL_SHAPES, (T, B, H), the same kinds of edge case for
#: the backward's cluster step: B = 1, B not a multiple of the rows (13),
#: T = 1, H whose units a CTA are not a multiple of 4 (136: C = 8, U = 17;
#: 20: C = 4, U = 5; 6: C = 2, U = 3) and a batch that takes clusters of 4
#: (both directions) and of 8 (one direction) (64); every case has a row of
#: length T and one of length 1.
GRU_BWD_CASES = [(128, 1, 128), (37, 13, 128), (1, 12, 128), (9, 5, 136), (9, 7, 20), (9, 5, 6),
                 (17, 64, 128)]
#: Both GRU kernels at the recognizer's shapes, (T, B, H), one direction:
#: DeepSpeech2's recurrent blocks at the configs' batch of 4 and H = 64, at
#: the 512 and 256 buckets; each case has rows of length T, 1 and 0 and one
#: drawn between (the collate's padding rows have length 0).
RECOGNIZER_GRU_CASES = [(512, 4, 64), (256, 4, 64)]
#: gru_fwd timed at T = 128, H = 128, both directions: the test step's batch
#: (12), bench.py's (16) and the large train batch (256).
GRU_FWD_TIMED_B = (12, 16, 256)
#: gru_bwd timed at the same shapes: the test step's, bench.py's and the
#: large train batch.
GRU_BWD_TIMED_B = (12, 16, 256)
F32_TOL = 1e-5
# bf16: both sides round the carry to bf16 every step; one flip of the last
# bit (2^-8 at |h| < 1) can propagate, so allow two steps of it.
BF16_TOL = 2.0**-7
# GRU backward, relative to max(|ref|, 1): f32 sums T*B terms of dW in
# another order; bf16 stores dx_proj in bf16 (2^-8 relative) and a one-ulp
# flip of the rounded dhg at one step moves the f32 carry and later
# roundings, so allow four ulps of the largest value.
BWD_F32_TOL = 1e-4
BWD_BF16_TOL = 2.0**-6
# The storage types of the recurrent kernels with their tolerances: an f16
# instance is held to bf16's (f16 rounds at 2^-11, inside it).
FWD_DTYPES = ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL), (torch.float16, BF16_TOL))
BWD_DTYPES = ((torch.float32, BWD_F32_TOL), (torch.bfloat16, BWD_BF16_TOL),
              (torch.float16, BWD_BF16_TOL))
#: The 16-bit types beside float32 that the recurrences, the TV stack and
#: the decode's caches take.
HALF_DTYPES = (torch.bfloat16, torch.float16)
P2CP_TOL = 1e-5
P2CP_ROWS = 12 * 128 * 10  # the thesis valid batch: B * T * Nart contour pairs
#: [kernel] P2CP cases, (R, N, M): the metric's rows, an odd row count, N != M
#: off the lane grid, a wide shape that takes several u tiles and v chunks,
#: and one that takes the small tile.
P2CP_CASES = [(P2CP_ROWS, 50, 50), (1001, 50, 50), (1001, 37, 61), (257, 400, 300), (1001, 7, 5)]
TRAIN = dict(batch=12, lr=1e-4, wd=1e-5, dropout=0.1, n_train=48, n_valid=12, epochs=2)
TO_MM = mm_per_unit(DATASET_CONFIG["artspeech2"])
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s without tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
REPLACES = {
    "gru_fwd": "artspeech_tpu/ops/pallas_gru.py:80 (_gru_fwd_kernel, pallas_call at :212)",
    "gru_bwd": "artspeech_tpu/ops/pallas_gru.py:117 (_gru_bwd_kernel, pallas_call at :251)",
    "p2cp": "artspeech_tpu/ops/pallas_kernels.py:31 (_p2cp_kernel, pallas_call at :76)",
    "min_dist": "artspeech_tpu/ops/pallas_kernels.py:41 (_min_dist_kernel, pallas_call at :76)",
    "flash_decode": "artspeech_tpu/ops/pallas_attention.py:86 (_flash_kernel, pallas_call at :157)",
    "train_attention_fwd": "artspeech_tpu/ops/pallas_train_attention.py:100 (_fwd_kernel, "
                           "pallas_call at :192)",
    "train_attention_bwd": "artspeech_tpu/ops/pallas_train_attention.py:124 (_bwd_kernel, "
                           "pallas_call at :215)",
    "lstm_fwd": "artspeech_tpu/ops/pallas_gru.py:321 (_lstm_fwd_kernel, pallas_call at :465)",
    "lstm_bwd": "artspeech_tpu/ops/pallas_gru.py:357 (_lstm_bwd_kernel, pallas_call at :507)",
    "gru_seq": "artspeech_tpu/ops/pallas_kernels.py:142 (_gru_seq_kernel, pallas_call at :198)",
}
KERNELS = tuple(REPLACES)
#: The storage types each kernel is held to its plain version at (the
#: training attention, gru_seq and P2CP compute in f32 only, as their TPU
#: kernels; their callers cast 16-bit inputs up, as JAX does).
DTYPES_HELD = {k: ["float32", "bfloat16", "float16"] for k in KERNELS}
DTYPES_HELD.update({k: ["float32"] for k in ("p2cp", "train_attention_fwd",
                                              "train_attention_bwd")})
DTYPES_HELD["gru_seq"] = ["float32", "bfloat16 x_proj (cast to f32)"]
#: The library (ops/csrc/<name>.cu) of each kernel.
LIBRARY = {**{k: k for k in KERNELS}, "train_attention_fwd": "train_attention",
           "train_attention_bwd": "train_attention"}
LIBRARIES = tuple(dict.fromkeys(LIBRARY.values()))
# min_dist rounds each squared distance as its plain version does, so both
# pick the same pair; the distances differ by the sqrt's rounding at most.
MIN_DIST_TOL = 1e-6
TEST_ROWS = 12 * 128  # the thesis test batch at bucket 128: B * T frames per TV
TV_SHAPES = {"LA": (50, 50), "TTCD": (15, 25), "TBCD": (20, 40), "VEL": (15, 50)}  # (N, M)
#: The test step's stack: the 10 articulators and the upper incisor, sorted.
TV_STACK_ARTS = sorted(set(RECOGNITION_ARTICULATORS) | {UPPER_INCISOR})
REPO = os.path.dirname(os.path.abspath(__file__))
THESIS_CONFIGS = os.path.join(REPO, "configs", "model_free")
#: The [cli] corpus: one subject, S01-S05 split as train_model_free.yaml
#: splits them, about 75 frames a sentence: above bucket 64 after tail
#: clipping, so that batches take bucket 128 (100 frames until the
#: [synthetic] phase came: the CLI phases are host bound, per frame).
CLI_CORPUS = dict(subject="subject1", sequences=("S01", "S02", "S03", "S04", "S05"),
                  n_sentences=3, frames_per_sentence=75)
# Card against CPU, the test step: the tract variables and metrics of one
# test batch within 1e-4 (f32 sums in another order), and the same argmin
# pair on at least 99 % of the frames (near-ties may flip on ulp-level
# differences of the model outputs; there the values still agree).
TEST_STEP_TOL = 1e-4
TV_SAME_PAIR_SHARE = 0.99
#: bf16 forward, card against CPU, relative to max |ref|: four bf16 rounding
#: steps (2^-8 each) of a sigmoid output in [0, 1]; see half_against_cpu.
BF16_FORWARD_TOL = 2.0**-6
#: flash decode against its plain version: both read the same cache values
#: (bf16 widened exactly) and differ by the order of f32 sums and the online
#: softmax's rescaling.
FLASH_RTOL, FLASH_ATOL = 1e-5, 2e-5
HD = 16  # the transformer config's head dim: embed 64 / 4 heads
DECODE_T = 128
#: flash_decode's checks: n_rows at the ends and inside (2 and 127 split
#: unevenly), and lane counts that are not a multiple of 32 or 64 (odd: one
#: lane a thread; even: a ragged last block of lane pairs).
FLASH_CHECKED_ROWS = (1, 2, 33, 127, 128)
FLASH_RAGGED_G = (4321, 4330)
#: flash_decode's timings: n_rows of single calls, and the L2-overflowing
#: bytes of cache copies the calls cycle through (the decode streams 8
#: caches between two reads of one).
FLASH_TIMED_ROWS = (1, 16, 64, 128)
FLASH_STREAM_BYTES = 200_000_000
DECODE_BATCHES = (12, 64)  # the thesis batch and the test CLI's generate batch on the card
BAND_T = (32, 64, 128)
TRANSFORMER_TOL = 1e-4  # card against CPU: forward, encode, per-frame decode
#: Training attention against its plain version: the forward differs by the
#: order of f32 sums and the online softmax's rescaling (absolute); the
#: gradients sum L terms in another order (relative to max(|ref|, 1)).
TRAIN_ATTN_FWD_TOL, TRAIN_ATTN_BWD_TOL = 2e-5, 1e-4
TRAIN_ATTN_G = {1: 360, 12: 4320, 64: 23040}  # B * C * (C-1) * H of the thesis transformer
TRAIN_ATTN_PAIRS = 90
#: Lengths at the edges of the training-attention backward's query strips
#: (one row, a strip, a strip and one, ...), held with the dropout keep at B = 1.
TRAIN_ATTN_EDGE_L = (1, 16, 33, 65, 129, 255, 512)
#: Buckets past MAX_L = 512 (the streamed kernels at hd 16): the one the
#: loader adds for a LONG_SENTENCE-frame sentence (rounded up to 64) and 1,024.
TRAIN_ATTN_LONG_L = (576, 1024)
#: (hd, L) of the streamed kernels' own [kernel] cases, at B = 1 with both
#: keeps: hd 64 and 128 at L 128 and 576, hd 33 (rows padded to 64) at 65,
#: and at hd 16 one past MAX_L and one past the loader's 576.
TRAIN_ATTN_STREAM_CASES = ((64, 128), (64, 576), (128, 128), (128, 576), (33, 65), (16, 513),
                           (16, 577))
#: Head dims of the timed shapes at B = 12, L = 128 beside the transformer's
#: 16 (the streamed kernels).
TRAIN_ATTN_TIMED_HD = (64, 128)
LONG_SENTENCE = 530  # frames: 9.6 s at gottingen's 55 fps
LONG_B = 2
TRAIN_T = 128
TRAIN_BATCHES = (12, 64)  # the thesis batch and the test CLI's batch on the card
MICROBATCHES = (64, 16, 8)  # the accum_steps sweep at B = 64
#: The LSTM kernels against their plain versions, (T, B, H): the latent
#: RNN's B = 12 and B = 64 at T = 128 and H = 128 and its synthesis batch
#: (16), and T in {1, 7, 128},
#: B in {1, 3, 12, 64}, H in {16, 64, 128} around them; each in f32 and
#: bf16, both directions in one launch and each alone, ragged lengths with a
#: full row and (B > 1) a row of length 1. Wider H: [widths].
#: The backward's cluster step adds GRU_BWD_CASES' kinds: B = 1 at T = 128,
#: B = 13, H = 136 / 20 / 6 (17 / 5 / 3 units a CTA) and B = 64 at H = 128
#: (clusters of 4, one direction 8).
LSTM_CASES = [(128, 12, 128), (128, 64, 128), (7, 3, 64), (1, 1, 16), (7, 64, 16),
              (128, 3, 64), (1, 12, 128), (128, 1, 128), (37, 13, 128), (9, 5, 136),
              (9, 7, 20), (9, 5, 6), (17, 64, 128), (128, 16, 128)]
#: Timed, (T, B, H): the latent RNN's train batches and its synthesis batch.
LSTM_SHAPES = [(128, 12, 128), (128, 64, 128), (128, 16, 128)]
#: [gru_seq] cases (B, T, H, batch tile): B = 1, B not a multiple of the
#: tile or of the cluster's rows, ragged rows, T = 1, H 16, 20, 128, 136 and
#: 256 (the cluster step; 20 and 136 give 5 and 17 units a CTA) and 512 (the
#: wide instance, W_h through the L2); the tile changes neither the launch
#: nor the result.
GRU_SEQ_CASES = [(21, 37, 16, 16), (16, 128, 128, 16), (5, 11, 16, 4), (3, 1, 128, 16),
                 (37, 13, 256, 16), (9, 128, 128, 4), (1, 9, 128, 16), (13, 6, 20, 1),
                 (7, 5, 136, 8), (64, 17, 128, 16), (5, 9, 512, 4)]
GRU_SEQ_TIMED_B = (16, 256)
#: (B, T, H, tile) of the [gru_seq] case with a tile above 32 and a bf16 x_proj.
GRU_SEQ_WIDENED = (37, 17, 128, 33)
#: [widths]: hidden sizes the resident recurrent kernels refused (H % 4 != 0,
#: 3H or 2H above 1,024 threads, W_h above a block's shared memory).
WIDE_RNN_H = {"gru_": (6, 130, 256, 512, 1024), "lstm": (168, 256, 512, 1024)}
#: The instance gru_fwd takes at each of those H, (f32, bf16): the cluster
#: step wherever a CTA's W_h slice fits (C = 2 at 6, 8 at 256 and at 512 in
#: bf16), the wide one where it does not (1,024; 512 in f32) or where a CTA
#: would hold more than 64 units (130 = 2 * 65).
GRU_FWD_INSTANCE = {6: ("cluster", "cluster"), 130: ("wide", "wide"), 256: ("cluster", "cluster"),
                    512: ("wide", "cluster"), 1024: ("wide", "wide")}
#: The instance lstm_fwd takes at its [widths] H, (f32, bf16): the cluster
#: step to H = 256 (C = 8: a 128 KiB W_h slice in f32 at 256), the wide one
#: at 512 and 1,024, where a CTA's slice exceeds its shared memory.
LSTM_FWD_INSTANCE = {168: ("cluster", "cluster"), 256: ("cluster", "cluster"),
                     512: ("wide", "wide"), 1024: ("wide", "wide")}
#: The instance the backwards take at those H, in f32 and bf16 alike: the
#: cluster step to H = 256, the wide one above.
BWD_INSTANCE = {6: "cluster", 130: "cluster", 168: "cluster", 256: "cluster", 512: "wide",
                1024: "wide"}
#: (hd, L) of the training attention beyond its resident kernels (hd above
#: 32, or L past MAX_L = 512), then head dims other than the transformer's 16
#: at L 128 and 512 (each printed with the instance it takes).
WIDE_TRAIN_ATTN = [(hd, l) for hd in (48, 64, 128) for l in (37, 128, 512)] + [
    (16, 513), (48, 600)] + [(hd, l) for hd in (8, 17, 32) for l in (128, 512)]
WIDE_FLASH_HD = (80, 128, 256)
WIDE_TIMED_H, WIDE_TIMED_FLASH_HD = 256, 128
#: The forwards' timed wide instances: at H = 256 they take the cluster step.
WIDE_TIMED_GRU_FWD_H = WIDE_TIMED_LSTM_FWD_H = 512
#: The backwards' timed wide instances: at H = 256 they take the cluster step.
WIDE_TIMED_BWD_H = 512
PC_CONFIGS = os.path.join(REPO, "configs", "autoencoder_based")
REC_CONFIGS = os.path.join(REPO, "configs", "phoneme_recognition")
REC_VOICING = os.path.join(REC_CONFIGS, "voicing.json")
#: The recognizer's train configs and the epochs each runs on the [cli] corpus.
REC_TRAIN_EPOCHS = {"train_acoustic": 2, "train_vocal_tract": 2, "train_vocal_tract_bf16": 2,
                    "train_air_column": 1, "train_air_column_voicing": 1,
                    "train_vocal_tract_voicing": 1}
#: The non-synthetic test configs that read no sentence wavs (test_acoustic's
#: melspec needs them, and the test CLI, as JAX's, reads none), each with the
#: train run whose best checkpoint it reads.
REC_TESTS = {"test_air_column": "train_air_column",
             "test_air_column_voicing": "train_air_column_voicing",
             "test_vocal_tract": "train_vocal_tract",
             "test_vocal_tract_voicing": "train_vocal_tract_voicing"}
REC_PATHS = tuple(f"rec_{name}" for name in (*REC_TRAIN_EPOCHS, *REC_TESTS))
REC_BUCKETS = (64, 128, 256, 512)
#: The profiled recognizer steps: B = 4 (the configs'), 5.1 s of 16 kHz audio
#: (319 melspec frames, bucket 512), and vocal-tract features (2, 500, 256).
REC_PROFILE_B = 4
REC_AUDIO_S = 5.1
REC_VT_T = 256
#: Card against CPU, the recognizer's eval batch: logits and log-probs.
REC_TOL = 1e-4
#: The conv stem bias's float32 gradient against float64, in units of 2^-24
#: times the summed magnitudes of its terms (recognizer_train_against_cpu).
REC_BIAS_ROUNDING = 8.0
#: [synthetic]: the seven test_synthetic_* configs, and the [cli], [pc] and
#: [mean_contour] synthesis directories (in the temporary directory) that
#: stand for the corpora their datadirs name: the model-free generate
#: config's save_to (results/synthesis) and the three methods' own.
SYNTHETIC_TESTS = tuple(sorted(name[:-5] for name in os.listdir(REC_CONFIGS)
                               if name.startswith("test_synthetic_")))
SYNTHESIS_DIRS = {"results/synthesis": "synthesis",
                  "results/synthesis_encoder_decoder": "synthesis",
                  "results/synthesis_autoencoder": "pc_synthesis",
                  "results/synthesis_mean_contour": "mc_synthesis"}
SYNTHETIC_PATHS = tuple(f"syn_{name}" for name in SYNTHETIC_TESTS) + ("syn_pc_train_recognizer",)
#: [synthetic]: the train steps through a frozen recognizer at the thesis
#: batch (12) and bucket (128); the recognizer's one-direction GRU there
#: (T, B, H) for the kernel checks and timings; beta4 of the latent-RNN loss.
FROZEN_B, FROZEN_T = 12, 128
FROZEN_GRU = (FROZEN_T, FROZEN_B, 64)
FROZEN_BETA4 = 0.5
#: The [latent_rnn] phase: train_autoencoder_based.yaml's latent RNN (embed
#: 64, hidden 128, latent 35 from its indices_dict) with rnn: LSTM, its loss
#: over a seeded frozen autoencoder (in 100, hidden 50), trained at its batch
#: (12) and at 64, T = 128; the synthesis forward at bench.py's B = 16.
LATENT_T, LATENT_BATCHES, SYNTH_B = 128, (12, 64), 16


def check(cond, message):
    if not cond:
        raise RuntimeError(message)


def phase(tag, /, **fields):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def fmt(values):
    return {k: (f"{v:.6g}" if isinstance(v, float) else v) for k, v in values.items()}


def cuda_ms(fn, iters):
    """Mean milliseconds per call by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, ref):
    """max |got - ref| / max(max |ref|, 1)."""
    scale = max(ref.float().abs().max().item(), 1.0)
    return ((got.float() - ref.float()).abs().max() / scale).item()


#: Libraries whose kernels' registers and spills [build] prints.
PTXAS_REPORTED = ("gru_fwd", "gru_seq", "gru_bwd", "lstm_fwd", "lstm_bwd", "flash_decode",
                  "train_attention", "p2cp", "min_dist")


def kernel_base(mangled):
    """(name, the rest) of the first length-prefixed identifier in a mangled
    name that ends in _kernel, as 22gru_fwd_cluster_kernel or 11p2cp_kernel;
    (mangled, "") if none does."""
    for i in range(len(mangled)):
        for j in range(i + 1, min(i + 4, len(mangled))):
            if not mangled[i:j].isdigit():
                break
            ident = mangled[j:j + int(mangled[i:j])]
            if ident.endswith("_kernel") and re.fullmatch(r"[a-z_][a-z0-9_]*", ident):
                return ident, mangled[j + len(ident):]
    return mangled, ""


def ptxas_kernels(report):
    """(kernel, registers, spill stores, spill loads) of each entry function
    in an -Xptxas -v report; kernel is the function's name with its template
    arguments (storage type, then integers and bools), as in
    gru_fwd_cluster_kernel<bf16,8>, <f16,8> or flash_decode_kernel<f32,16,2,1>."""
    kernels, name, spills = [], None, (0, 0)
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            base, rest = kernel_base(entry.group(1))
            templated = re.match(r"(I\w*?E)E", rest)
            args = templated.group(1) if templated else ""
            targs = (["bf16"] if "bfloat16" in args else ["f16"] if "6__half" in args
                     else ["f32"] if args.startswith("If") else [])
            targs += re.findall(r"L[ib](\d+)E", args)
            name = base + (f"<{','.join(targs)}>" if targs else "")
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            spills = (int(spill.group(1)), int(spill.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            kernels.append((name, int(regs.group(1)), *spills))
            name, spills = None, (0, 0)
    return kernels


def build_all():
    names = LIBRARIES
    fresh = {n: not os.path.exists(_build.library_path(n)) for n in names}
    t0 = time.perf_counter()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as pool:
        for name, future in [(n, pool.submit(_build.build, n)) for n in names]:
            future.result()
            phase("build", kernel=name, compiled=fresh[name])
    phase("build", kernels=len(names), seconds=f"{time.perf_counter() - t0:.2f}")
    for name in PTXAS_REPORTED:
        for kernel, regs, stores, loads in ptxas_kernels(_build.ptxas_report(name)):
            phase("build", library=name, kernel=kernel, registers=regs, spill_stores=stores,
                  spill_loads=loads)


# -- kernels against their plain versions -------------------------------------

def gru_inputs(t, b, h, n_dir, dtype, seed, short_row=False):
    """Seeded x_proj (T, B, D*3H), w_h (D, H, 3H), b_h (D, 3H), ragged mask (T, B)
    with a row of length T and, with ``short_row`` and B > 1, one of length 1."""
    g = torch.Generator().manual_seed(seed)
    xp = torch.randn(t, b, n_dir * 3 * h, generator=g) * 0.5
    wh = torch.randn(n_dir, h, 3 * h, generator=g) * 0.1
    bh = torch.randn(n_dir, 3 * h, generator=g) * 0.1
    lengths = torch.randint(1, t + 1, (b,), generator=g)
    if short_row and b > 1:
        lengths[-1] = 1
    lengths[0] = t
    mask = torch.arange(t)[:, None] < lengths[None, :]
    return [v.to(dtype).cuda() for v in (xp, wh, bh)] + [mask.cuda()]


def recognizer_gru_inputs(t, b, h, dtype, seed):
    """One direction's x_proj (T, B, 3H), w_h (H, 3H), b_h (3H,) and a mask
    (T, B) with rows of length T, 1, 0 and the rest drawn in [1, T]."""
    g = torch.Generator().manual_seed(seed)
    xp = torch.randn(t, b, 3 * h, generator=g) * 0.5
    wh = torch.randn(h, 3 * h, generator=g) * 0.1
    bh = torch.randn(3 * h, generator=g) * 0.1
    lengths = torch.randint(1, t + 1, (b,), generator=g)
    lengths[:3] = torch.tensor([t, 1, 0])
    mask = torch.arange(t)[:, None] < lengths[None, :]
    return [v.to(dtype).cuda() for v in (xp, wh, bh)] + [mask.cuda()]


def bigru_reference(xp, wh, bh, mask):
    return hopper_gru.gru_forward_reference(xp, wh, bh, mask, 0b10)


def bigru_backward_reference(xp, wh, bh, mask, ys, g):
    return hopper_gru.gru_backward_reference(xp, wh, bh, mask, ys, g, 0b10)


def geometry_fields(b, n_dir, h, gates, dtype):
    """The launch of gru_fwd or gru_seq (gates 3) or lstm_fwd (4) at a shape:
    instance, cluster size C, rows a cluster, CTAs, threads a CTA, and the
    waves they take at one CTA an SM."""
    elem = torch.empty(0, dtype=dtype).element_size()
    geo = hopper_gru.gru_launch_geometry(b, n_dir, h, gates, elem,
                                         torch.cuda.get_device_properties(0).multi_processor_count)
    return dict(instance="cluster" if geo.resident else "wide", C=geo.cluster, rows=geo.rows,
                ctas=geo.ctas, threads=geo.threads, waves=geo.waves)


def bwd_geometry_fields(b, n_dir, h, gates, dtype):
    """The launch of gru_bwd (gates 3) or lstm_bwd (4) at a shape, as
    geometry_fields gives the forward's."""
    elem = torch.empty(0, dtype=dtype).element_size()
    geo = hopper_gru.rnn_bwd_launch_geometry(
        b, n_dir, h, gates, elem, torch.cuda.get_device_properties(0).multi_processor_count)
    return dict(instance="cluster" if geo.resident else "wide", C=geo.cluster, rows=geo.rows,
                ctas=geo.ctas, threads=geo.threads, waves=geo.waves)


def repeats_bitwise(fn, got):
    """Whether a second call of fn returns tensors equal bit for bit to got."""
    again = fn()
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(got, again))


def gru_fwd_vs_plain():
    """The forward kernel against its plain version at KERNEL_SHAPES and
    GRU_FWD_CASES, both directions in one launch and each alone, f32 within
    F32_TOL and bf16 within BF16_TOL. Returns the largest f32 error at the
    bench shape."""
    worst = 0.0
    for t, b, h in KERNEL_SHAPES + GRU_FWD_CASES:
        for dtype, tol in FWD_DTYPES:
            xp, wh, bh, mask = gru_inputs(t, b, h, 2, dtype, seed=t + b + h, short_row=True)
            got = hopper_gru.bigru_sequence(xp, wh, bh, mask)
            torch.cuda.synchronize()
            err = (got.float() - bigru_reference(xp, wh, bh, mask).float()).abs().max().item()
            errs = {"bidirectional": err}
            gates = 3 * h
            for d, reverse in ((0, False), (1, True)):
                x_d = xp[..., d * gates:(d + 1) * gates].contiguous()
                one = hopper_gru.gru_sequence(x_d, wh[d], bh[d], mask, reverse)
                ref = hopper_gru.gru_sequence_reference(x_d, wh[d], bh[d], mask, reverse)
                errs["reverse" if reverse else "forward"] = (one.float() - ref.float()).abs().max().item()
            torch.cuda.synchronize()
            geo = geometry_fields(b, 2, h, 3, dtype)
            phase("kernel", kernel="gru_fwd", T=t, B=b, H=h, dtype=str(dtype).split(".")[-1],
                  tol=tol, C=geo["C"], rows=geo["rows"], instance=geo["instance"],
                  **{f"max_abs_err_{k}": v for k, v in errs.items()})
            check(all(np.isfinite(v) and v <= tol for v in errs.values()),
                  f"gru kernel disagrees with its plain version at {(t, b, h)} {dtype}: {errs}")
            if dtype == torch.float32 and (t, b) == (BENCH_T, BENCH_B):
                worst = max(worst, *errs.values())
    for t, b, h in RECOGNIZER_GRU_CASES:
        for dtype, tol in FWD_DTYPES:
            xp, wh, bh, mask = recognizer_gru_inputs(t, b, h, dtype, seed=t + h)
            errs, zero_row = {}, 0.0
            for reverse in (False, True):
                one = hopper_gru.gru_sequence(xp, wh, bh, mask, reverse)
                ref = hopper_gru.gru_sequence_reference(xp, wh, bh, mask, reverse)
                errs["reverse" if reverse else "forward"] = (one.float() - ref.float()).abs().max().item()
                zero_row = max(zero_row, one[:, 2].float().abs().max().item())
            torch.cuda.synchronize()
            geo = geometry_fields(b, 1, h, 3, dtype)
            phase("kernel", kernel="gru_fwd", T=t, B=b, H=h, directions=1, lengths="T,1,0,...",
                  dtype=str(dtype).split(".")[-1], tol=tol, C=geo["C"], rows=geo["rows"],
                  ctas=geo["ctas"], threads=geo["threads"], instance=geo["instance"],
                  length0_row_max_abs=zero_row,
                  **{f"max_abs_err_{k}": v for k, v in errs.items()})
            check(all(np.isfinite(v) and v <= tol for v in errs.values()) and zero_row == 0.0,
                  f"gru kernel disagrees with its plain version at {(t, b, h)} one direction "
                  f"{dtype}: {errs}, length-0 row {zero_row}")
    return worst


def gru_bwd_vs_plain():
    """The backward kernel against its plain version (dx_proj, dW_h, db_h,
    relative to max(|ref|, 1)) at KERNEL_SHAPES and GRU_BWD_CASES, both
    directions in one launch and each alone, f32 within BWD_F32_TOL and
    bf16 within BWD_BF16_TOL, and in f32 against torch.autograd through the
    plain forward; a second launch gives the same bits. Returns the largest
    f32 absolute error max |got - ref| over dx_proj, dW_h and db_h against
    the plain version, and the largest f32 relative one."""
    worst_abs, worst_rel = 0.0, 0.0
    for t, b, h in KERNEL_SHAPES + GRU_BWD_CASES:
        gates = 3 * h
        for dtype, tol in BWD_DTYPES:
            xp, wh, bh, mask = gru_inputs(t, b, h, 2, dtype, seed=2 * t + b + h,
                                          short_row=(t, b, h) in GRU_BWD_CASES)
            gy = torch.randn(t, b, 2 * h, generator=torch.Generator().manual_seed(b),
                             device="cpu").to(dtype).cuda()
            ys = bigru_reference(xp, wh, bh, mask)
            got = hopper_gru.gru_backward(xp, wh, bh, mask, ys, gy, 0b10)
            ref = bigru_backward_reference(xp, wh, bh, mask, ys, gy)
            bitwise = repeats_bitwise(lambda: hopper_gru.gru_backward(xp, wh, bh, mask, ys, gy,
                                                                      0b10), got)
            pairs = {f"bidirectional_{n}": (a, r) for n, a, r in zip(("dx", "dW", "db"), got, ref)}
            for d, reverse in ((0, False), (1, True)):
                x_d = xp[..., d * gates:(d + 1) * gates].contiguous()
                ys_d = ys[..., d * h:(d + 1) * h].contiguous()
                g_d = gy[..., d * h:(d + 1) * h].contiguous()
                one = hopper_gru.gru_backward(x_d, wh[d:d + 1], bh[d:d + 1], mask, ys_d, g_d,
                                              int(reverse))
                ref_d = hopper_gru.gru_sequence_backward_reference(x_d, wh[d], bh[d], mask, ys_d,
                                                                   g_d, reverse)
                for n, a, r in zip(("dx", "dW", "db"), (one[0], one[1][0], one[2][0]), ref_d):
                    pairs[f"{'reverse' if reverse else 'forward'}_{n}"] = (a, r)
            errs = {k: rel_err(a, r) for k, (a, r) in pairs.items()}
            abs_errs = {k: (a.float() - r.float()).abs().max().item() for k, (a, r) in pairs.items()}
            if dtype == torch.float32:
                params = [v.clone().requires_grad_() for v in (xp, wh, bh)]
                with torch.enable_grad():
                    auto = torch.autograd.grad(bigru_reference(*params, mask), params, gy)
                for n, a, r in zip(("dx", "dW", "db"), got, auto):
                    errs[f"autograd_{n}"] = rel_err(a, r)
            torch.cuda.synchronize()
            geo = bwd_geometry_fields(b, 2, h, 3, dtype)
            phase("kernel", kernel="gru_bwd", T=t, B=b, H=h, dtype=str(dtype).split(".")[-1],
                  tol=tol, C=geo["C"], rows=geo["rows"], instance=geo["instance"],
                  one_direction_C=bwd_geometry_fields(b, 1, h, 3, dtype)["C"], bitwise=bitwise,
                  **{f"rel_err_{k}": f"{v:.3g}" for k, v in errs.items()},
                  **{f"max_abs_err_{k}": f"{v:.3g}" for k, v in abs_errs.items()})
            check(all(np.isfinite(v) and v <= tol for v in errs.values()),
                  f"gru_bwd kernel disagrees with its plain version at {(t, b, h)} {dtype}: {errs}")
            check(bitwise, f"gru_bwd gave other bits on a second launch at {(t, b, h)} {dtype}")
            if dtype == torch.float32:
                worst_abs = max(worst_abs, *abs_errs.values())
                worst_rel = max(worst_rel, *errs.values())
    for t, b, h in RECOGNIZER_GRU_CASES:
        for dtype, tol in BWD_DTYPES:
            xp, wh, bh, mask = recognizer_gru_inputs(t, b, h, dtype, seed=2 * t + h)
            gy = torch.randn(t, b, h, generator=torch.Generator().manual_seed(t),
                             device="cpu").to(dtype).cuda()
            errs, abs_errs, bitwise, zero_row = {}, {}, True, 0.0
            for reverse in (False, True):
                ys = hopper_gru.gru_sequence_reference(xp, wh, bh, mask, reverse)

                def bwd():
                    return hopper_gru.gru_backward(xp, wh[None], bh[None], mask, ys, gy,
                                                   int(reverse))

                got = bwd()
                bitwise = bitwise and repeats_bitwise(bwd, got)
                ref = hopper_gru.gru_sequence_backward_reference(xp, wh, bh, mask, ys, gy,
                                                                 reverse)
                name = "reverse" if reverse else "forward"
                for n, a, r in zip(("dx", "dW", "db"), (got[0], got[1][0], got[2][0]), ref):
                    errs[f"{name}_{n}"] = rel_err(a, r)
                    abs_errs[f"{name}_{n}"] = (a.float() - r.float()).abs().max().item()
                zero_row = max(zero_row, got[0][:, 2].float().abs().max().item())
                if dtype == torch.float32:
                    params = [v.clone().requires_grad_() for v in (xp, wh, bh)]
                    with torch.enable_grad():
                        auto = torch.autograd.grad(
                            hopper_gru.gru_sequence_reference(*params, mask, reverse), params, gy)
                    for n, a, r in zip(("dx", "dW", "db"), (got[0], got[1][0], got[2][0]), auto):
                        errs[f"autograd_{name}_{n}"] = rel_err(a, r)
            torch.cuda.synchronize()
            geo = bwd_geometry_fields(b, 1, h, 3, dtype)
            phase("kernel", kernel="gru_bwd", T=t, B=b, H=h, directions=1, lengths="T,1,0,...",
                  dtype=str(dtype).split(".")[-1], tol=tol, C=geo["C"], rows=geo["rows"],
                  ctas=geo["ctas"], threads=geo["threads"], instance=geo["instance"],
                  bitwise=bitwise, length0_row_dx_max_abs=zero_row,
                  **{f"rel_err_{k}": f"{v:.3g}" for k, v in errs.items()},
                  **{f"max_abs_err_{k}": f"{v:.3g}" for k, v in abs_errs.items()})
            check(all(np.isfinite(v) and v <= tol for v in errs.values()) and zero_row == 0.0,
                  f"gru_bwd kernel disagrees with its plain version at {(t, b, h)} one "
                  f"direction {dtype}: {errs}, length-0 row {zero_row}")
            check(bitwise, f"gru_bwd gave other bits on a second launch at {(t, b, h)} {dtype}")
            if dtype == torch.float32:
                worst_abs = max(worst_abs, *abs_errs.values())
                worst_rel = max(worst_rel, *errs.values())
    return worst_abs, worst_rel


def p2cp_inputs(rows, seed, n=50, m=50):
    """Seeded u (R, 2, N) in [0, 1) and v (R, 2, M) near u's points."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand(rows, 2, n, generator=g)
    v = (u[..., torch.arange(m) % n] + 0.05 * torch.randn(rows, 2, m, generator=g)).clamp(0.0, 1.0)
    return u.cuda(), v.cuda()


def p2cp_geometry_fields(rows, n, m):
    """The launch rule's tile, blocks and warps at a shape, for the prints."""
    geo = hopper_p2cp.p2cp_launch_geometry(rows, n, m)
    return dict(tile=f"{geo.points_u}x{geo.points_v}", exact=geo.exact, u_tiles=geo.u_tiles,
                v_chunks=geo.v_chunks, warps=geo.warps, ctas=geo.blocks, smem=geo.smem_bytes)


def p2cp_cases():
    """(name, u, v): P2CP_CASES, and rows with a NaN coordinate (one of u's,
    one of v's, a whole u point, all of one v row's x)."""
    cases = [(f"R{rows}_{n}x{m}", *p2cp_inputs(rows, seed=rows + n + m, n=n, m=m))
             for rows, n, m in P2CP_CASES]
    u, v = p2cp_inputs(1001, seed=13)
    u[3, 0, 7] = v[10, 1, 49] = float("nan")
    u[20, :, 0] = v[500, 0, :] = float("nan")
    return cases + [("nan_rows", u, v)]


def p2cp_vs_plain():
    """The kernel against its plain version: NaN in exactly the rows where
    the plain version has it, elsewhere within P2CP_TOL, and a second launch
    the same bits. Returns the largest absolute error."""
    worst = 0.0
    for name, u, v in p2cp_cases():
        got = hopper_p2cp.mean_p2cp_channel_major(u, v)
        again = hopper_p2cp.mean_p2cp_channel_major(u, v)
        ref = hopper_p2cp.mean_p2cp_channel_major_reference(u, v)
        torch.cuda.synchronize()
        nan = ref.isnan()
        nan_equal = torch.equal(got.isnan(), nan)
        err = (got - ref)[~nan].abs().max().item() if (~nan).any() else 0.0
        same_bits = torch.equal(got.view(torch.int32), again.view(torch.int32))
        rows, n, m = u.shape[0], u.shape[-1], v.shape[-1]
        phase("kernel", kernel="p2cp", case=name, rows=rows, N=n, M=m, dtype="float32",
              tol=P2CP_TOL, max_abs_err=err, nan_rows=int(nan.sum()), nan_equal=nan_equal,
              same_bits=same_bits, **p2cp_geometry_fields(rows, n, m))
        check(nan_equal and np.isfinite(err) and err <= P2CP_TOL and same_bits,
              f"p2cp kernel disagrees with its plain version on {name}: NaN rows equal "
              f"{nan_equal}, error {err}, a second launch the same bits {same_bits}")
        worst = max(worst, err)
    return worst


def min_dist_inputs(rows, n, m, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(rows, 2, n, generator=g).cuda(), torch.rand(rows, 2, m, generator=g).cuda()


def min_dist_cases():
    """(name, u, v): each TV shape at the test batch's and an odd row count,
    two shapes that take the tile for any shape (50 x 51 and 64 x 64, in 2 x
    2 blocks of 32 x 32 points), three kinds of ties at the test batch's, and TBCD's
    inputs as the tract variables passed them before they took one launch: a
    strided window of a contour stack and a concatenated palate."""
    cases = [(f"{tv}_R{rows}", *min_dist_inputs(rows, n, m, seed=rows + n + m))
             for tv, (n, m) in TV_SHAPES.items() for rows in (TEST_ROWS, 1001)]
    cases += [(f"R1001_{n}x{m}", *min_dist_inputs(1001, n, m, seed=n + m))
              for n, m in ((50, 51), (64, 64))]
    u, v = min_dist_inputs(TEST_ROWS, 20, 30, seed=11)
    v[..., 7] = u[..., 12]
    v[..., 21] = u[..., 12]  # the same zero distance twice: (12, 7) must win
    u[..., 15] = u[..., 12]
    g = torch.Generator().manual_seed(12)
    stack = torch.rand(TEST_ROWS, 11, 2, 50, generator=g).cuda()
    palate = torch.cat([stack[:, 9, :, 0:25], stack[:, 6, :, 35:50]], dim=-1)
    return cases + [
        ("duplicated_points", u, v),
        ("identical_contours", torch.full_like(u, 0.25), torch.full_like(v, 0.75)),
        ("permutation", u, u[..., torch.randperm(20, generator=g).cuda()]),
        ("TBCD_strided_views", stack[:, 8, :, 10:30], palate),
    ]


def min_dist_geometry_fields(rows, shapes):
    """The launch rule's tiles (in the order the CTAs run them), warps and
    CTAs for a table, for the prints."""
    geo = hopper_min_dist.min_dist_launch_geometry(rows, shapes)
    tiles = ",".join("{}:{}x{}".format(p.slot, *hopper_min_dist.TILES[p.tile][:2])
                     for p in geo.problems)
    return dict(tiles=tiles, warps=geo.warps, ctas=geo.blocks, smem=geo.smem_bytes)


def distance_errors(got, ref):
    """(max absolute, max relative error) of distances where the plain
    version has a number, and whether both have NaN at the same places."""
    nan = ref.isnan()
    diff = (got - ref)[~nan].abs()
    if diff.numel() == 0:
        return 0.0, 0.0, torch.equal(got.isnan(), nan)
    rel = diff / ref[~nan].abs().clamp_min(torch.finfo(torch.float32).tiny)
    return diff.max().item(), rel.max().item(), torch.equal(got.isnan(), nan)


def tv_stack(rows, seed, dtype=torch.float32):
    """A seeded (R, 11, 2, 50) contour stack in the test step's articulator
    order (TV_STACK_ARTS)."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand(rows, len(TV_STACK_ARTS), 2, 50, generator=g).to(dtype).cuda()


def tv_stack_cases():
    """(name, stack): seeded stacks at the test batch's rows and an odd
    count; built-in ties (a lower-lip point equal to two upper-lip points,
    and in rows 0-99 identical contours, every distance 0); a NaN point in
    the tongue tip (rows 0-9) and the upper lip (rows 20-29); a bf16 and an
    f16 stack."""
    at = {name: i for i, name in enumerate(TV_STACK_ARTS)}
    ties = tv_stack(TEST_ROWS, seed=21)
    ties[:, at[UPPER_LIP], :, 12] = ties[:, at[LOWER_LIP], :, 7]
    ties[:, at[UPPER_LIP], :, 40] = ties[:, at[LOWER_LIP], :, 7]
    ties[:100] = 0.5
    nan = tv_stack(1001, seed=22)
    nan[:10, at[TONGUE], 0, 35] = float("nan")
    nan[20:30, at[UPPER_LIP], 1, 0] = float("nan")
    return [(f"tv_stack_R{rows}", tv_stack(rows, seed=rows)) for rows in (TEST_ROWS, 1001)] + [
        ("tv_stack_ties", ties), ("tv_stack_nan", nan),
        ("tv_stack_bf16", tv_stack(TEST_ROWS, seed=23, dtype=torch.bfloat16)),
        ("tv_stack_f16", tv_stack(TEST_ROWS, seed=24, dtype=torch.float16))]


def plain_tvs(stack):
    """The plain TV route on the card, (4, R, 5): the windows cut, the palate
    concatenated, min_distance_channel_major_reference and gathers, on the
    stack as f32 (the kernel widens a bf16 or f16 stack exactly)."""
    names, problems = tract_variables.tv_table({a: stack.shape[-1] for a in TV_STACK_ARTS})
    sources = [stack[..., TV_STACK_ARTS.index(n), :, :].float() for n in names]
    return hopper_min_dist.min_distance_windows_reference(sources, problems)


def kernel_tvs(stack):
    """tract_variables_from_stack on the card, packed as plain_tvs packs it."""
    tvs = tract_variables.tract_variables_from_stack(stack, TV_STACK_ARTS)
    return torch.stack([torch.cat([tvs[t]["value"][..., None], tvs[t]["poc_1"], tvs[t]["poc_2"]],
                                  dim=-1) for t in tract_variables.TV_WINDOWS])


def min_dist_vs_plain():
    """The kernel against its plain version: through the single entry
    (min_dist_cases), indices equal and distances within MIN_DIST_TOL
    relative; then one launch for a stack's four TVs (tv_stack_cases)
    against the plain TV route, values within MIN_DIST_TOL relative with
    NaN at the same places, both places of constriction the same bits, and
    a second launch the same bits. Returns the largest absolute distance
    error."""
    worst = 0.0
    for name, u, v in min_dist_cases():
        got = hopper_min_dist.min_distance_channel_major(u, v)
        ref = hopper_min_dist.min_distance_channel_major_reference(u, v)
        torch.cuda.synchronize()
        abs_err, rel, nan_equal = distance_errors(got[0], ref[0])
        same = bool(torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2]))
        phase("kernel", kernel="min_dist", case=name, rows=u.shape[0], N=u.shape[-1],
              M=v.shape[-1], dtype="float32", tol=MIN_DIST_TOL, max_abs_err=abs_err,
              max_rel_err=rel, indices_equal=same,
              **min_dist_geometry_fields(u.shape[0], [(u.shape[-1], v.shape[-1])]))
        check(same and nan_equal and np.isfinite(rel) and rel <= MIN_DIST_TOL,
              f"min_dist kernel disagrees with its plain version on {name}: "
              f"indices equal {same}, relative error {rel}")
        worst = max(worst, abs_err)
    for name, stack in tv_stack_cases():
        before = hopper_min_dist.launches
        got = kernel_tvs(stack)
        launches = hopper_min_dist.launches - before
        again = kernel_tvs(stack)
        ref = plain_tvs(stack)
        torch.cuda.synchronize()
        abs_err, rel, nan_equal = distance_errors(got[..., 0], ref[..., 0])
        points_equal = torch.equal(got[..., 1:].float().view(torch.int32),
                                   ref[..., 1:].view(torch.int32))
        same_bits = torch.equal(got.float().view(torch.int32), again.float().view(torch.int32))
        rows = stack.shape[0]
        phase("kernel", kernel="min_dist", case=name, rows=rows, tvs="+".join(tract_variables.TV_WINDOWS),
              dtype=str(stack.dtype).split(".")[-1], tol=MIN_DIST_TOL, max_abs_err=abs_err,
              max_rel_err=rel, nan_values=int(ref[..., 0].isnan().sum()), nan_equal=nan_equal,
              points_equal=points_equal, same_bits=same_bits, launches=launches,
              **min_dist_geometry_fields(rows, list(TV_SHAPES.values())))
        check(launches == 1 and nan_equal and points_equal and same_bits and np.isfinite(rel)
              and rel <= MIN_DIST_TOL,
              f"min_dist kernel disagrees with the plain TV route on {name}: launches "
              f"{launches}, NaN equal {nan_equal}, points equal {points_equal}, same bits "
              f"{same_bits}, relative error {rel}")
        worst = max(worst, abs_err)
    return worst


def flash_groups(b, c=10, heads=4):
    """The decode's lane counts G at batch b: self caches B*C*H, cross-channel
    caches B*C*(C-1)*H."""
    return {"self": b * c * heads, "inter": b * c * (c - 1) * heads}


def flash_inputs(g, dtype, seed, s=DECODE_T, hd=HD):
    """Seeded caches (S, hd, G) in ``dtype`` and a pre-scaled f32 query (hd, G)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = torch.randn(s, hd, g, generator=gen, device="cuda").to(dtype)
    v = torch.randn(s, hd, g, generator=gen, device="cuda").to(dtype)
    q = torch.randn(hd, g, generator=gen, device="cuda") * hd**-0.5
    return k, v, q


def flash_excess(got, ref):
    """How far the worst element lies beyond FLASH_ATOL + FLASH_RTOL * |ref|
    (<= 0: within), and max |got - ref|."""
    diff = (got - ref).abs()
    return (diff - FLASH_ATOL - FLASH_RTOL * ref.abs()).max().item(), diff.max().item()


def flash_geometry_fields(g, n_rows, dtype, hd=HD):
    """The launch of flash_decode at a shape (flash_decode_launch_geometry
    on this card): CTAs, CTAs a cluster, warps a CTA and lanes a thread."""
    geo = hopper_attention.flash_decode_launch_geometry(
        g, n_rows, hd, torch.finfo(dtype).bits // 8,
        torch.cuda.get_device_properties(0).multi_processor_count)
    return dict(ctas=geo.ctas, cluster=geo.cluster, warps=geo.warps, lanes=geo.lanes)


def flash_geometry_text(g, n_rows, dtype, hd=HD):
    return "/".join(str(v) for v in flash_geometry_fields(g, n_rows, dtype, hd).values())


def flash_decode_vs_plain():
    """The kernel against its plain version at every lane count of the
    decode's caches at B = 1, 12 and 64 and at FLASH_RAGGED_G (lane counts
    that are not a multiple of 32 or 64), n_rows in FLASH_CHECKED_ROWS, f32,
    bf16 and f16 caches, each with its launch geometry (CTAs/cluster/warps/lanes); and
    a second launch that gives the same bits. Returns the largest absolute
    error."""
    worst = 0.0
    cases = [(b, attend, g) for b in (1, 12, 64) for attend, g in flash_groups(b).items()]
    cases += [(None, "ragged", g) for g in FLASH_RAGGED_G]
    for b, attend, g in cases:
        for dtype in (torch.float32, *HALF_DTYPES):
            k, v, q = flash_inputs(g, dtype, seed=g)
            errs, same = {}, True
            for n_rows in FLASH_CHECKED_ROWS:
                got = hopper_attention.flash_decode_attend(k, v, q, n_rows)
                ref = hopper_attention.flash_decode_attend_reference(k, v, q, n_rows)
                errs[n_rows] = flash_excess(got, ref)
                same = same and repeats_bitwise(
                    lambda: (hopper_attention.flash_decode_attend(k, v, q, n_rows),), (got,))
            torch.cuda.synchronize()
            phase("kernel", kernel="flash_decode", B=b, attend=attend, G=g, hd=HD, S=DECODE_T,
                  dtype=str(dtype).split(".")[-1], rtol=FLASH_RTOL, atol=FLASH_ATOL,
                  bitwise_repeat=same,
                  **{f"max_abs_err_n{n}": f"{e[1]:.3g}" for n, e in errs.items()},
                  **{f"geometry_n{n}": flash_geometry_text(g, n, dtype) for n in errs})
            check(all(np.isfinite(e[1]) and e[0] <= 0 for e in errs.values()),
                  f"flash_decode kernel disagrees with its plain version at B={b} {attend} G={g} "
                  f"{dtype}: {errs}")
            check(same, f"flash_decode gave other bits on a second launch at G={g} {dtype}")
            worst = max(worst, *(e[1] for e in errs.values()))
    return worst


def train_attention_inputs(g, l, n_pairs, seed, hd=HD):
    """Seeded q (pre-scaled), k, v, dO (G, L, hd) on the card and a keep mask:
    the all-ones (1, L, L) with n_pairs = 1, or a dropout keep (p = 0.1)
    (n_pairs, L, L) pre-scaled by 1 / 0.9."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(g, l, hd, generator=gen, device="cuda") for _ in range(4))
    if n_pairs == 1:
        keep = torch.ones(1, l, l, device="cuda")
    else:
        keep = (torch.rand(n_pairs, l, l, generator=gen, device="cuda") >= 0.1).float() / 0.9
    return q * hd**-0.5, k, v, keep, do


def train_attention_geometry_text(g, l, hd, n_pairs):
    """Both kernels' launch geometries at one shape, for a [kernel] or
    [widths] line (the streamed kernels' with "stream:", the backward's dQ
    and dK/dV kernels each)."""
    if not hopper_train_attention.resident(l, hd):
        geo = {kind: hopper_train_attention.train_attention_stream_launch_geometry(g, l, hd, kind)
               for kind in hopper_train_attention.STREAM_KINDS}
        text = {kind: f"rows={hopper_train_attention.STREAM_ROWS},cols={x.cols},ctas={x.ctas},"
                      f"smem={x.smem_bytes}" for kind, x in geo.items()}
        return dict(fwd_geometry=f"stream:{text['fwd']}",
                    bwd_geometry=f"stream:dq:{text['dq']};dkv:{text['dkv']}")
    f = hopper_train_attention.train_attention_fwd_launch_geometry(g, l, hd, n_pairs)
    b = hopper_train_attention.train_attention_bwd_launch_geometry(g, l, hd)
    return dict(fwd_geometry=f"groups={f.groups},tq={f.tq},threads={f.threads},ctas={f.ctas},"
                             f"smem={f.smem_bytes}",
                bwd_geometry=f"groups={b.groups},tq={b.tq},threads={b.threads},nku={b.nku},"
                             f"ctas={b.ctas},smem={b.smem_bytes}")


def train_attention_cases():
    """(G, L, hd, n_pairs values): at hd 16 every batch's G at L 32 and 128,
    then L 512, a length that is no bucket (37) and the buckets past 512
    (TRAIN_ATTN_LONG_L, the streamed kernels) at B = 1, with the all-ones
    keep (n_pairs 1) and the dropout keep; the streamed kernels' own cases
    (TRAIN_ATTN_STREAM_CASES) at B = 1 with both keeps; then the strip edges
    at B = 1 with the dropout keep."""
    both = (1, TRAIN_ATTN_PAIRS)
    cases = [(g, l, HD, both) for g in TRAIN_ATTN_G.values() for l in (32, 128)] + [
        (TRAIN_ATTN_G[1], l, HD, both) for l in (512, 37, *TRAIN_ATTN_LONG_L)] + [
        (TRAIN_ATTN_G[1], l, hd, both) for hd, l in TRAIN_ATTN_STREAM_CASES]
    return cases + [(TRAIN_ATTN_G[1], l, HD, (TRAIN_ATTN_PAIRS,)) for l in TRAIN_ATTN_EDGE_L
                    if (TRAIN_ATTN_G[1], l, HD, both) not in cases]


def train_attention_vs_plain():
    """The forward and backward kernels against their plain versions at
    every case (the backward fed the forward kernel's out and lse), the
    second launch of each bit for bit (out and lse; dQ, dK, dV).
    Returns the largest absolute errors of the forward and of dQ/dK/dV."""
    worst_fwd = worst_bwd = 0.0
    for g, l, hd, pairs in train_attention_cases():
        for n_pairs in pairs:
            q, k, v, keep, do = train_attention_inputs(g, l, n_pairs,
                                                       seed=g + l + n_pairs + hd - HD, hd=hd)
            out, lse = hopper_train_attention.fused_causal_attend_fwd(q, k, v, keep, n_pairs)
            grads = hopper_train_attention.fused_causal_attend_bwd(q, k, v, keep, out, lse, do,
                                                                   n_pairs)
            ref = hopper_train_attention.fused_causal_attend_reference(q, k, v, keep, n_pairs)
            ref_grads = hopper_train_attention.fused_causal_attend_bwd_reference(q, k, v, keep,
                                                                                 do, n_pairs)
            torch.cuda.synchronize()
            fwd_err = (out - ref).abs().max().item()
            rel = {n: rel_err(a, r) for n, a, r in zip(("dq", "dk", "dv"), grads, ref_grads)}
            bwd_abs = max((a - r).abs().max().item() for a, r in zip(grads, ref_grads))
            same = repeats_bitwise(lambda: hopper_train_attention.fused_causal_attend_bwd(
                q, k, v, keep, out, lse, do, n_pairs), grads)
            fwd_same = repeats_bitwise(lambda: hopper_train_attention.fused_causal_attend_fwd(
                q, k, v, keep, n_pairs), (out, lse))
            phase("kernel", kernel="train_attention", G=g, L=l, hd=hd, n_pairs=n_pairs,
                  route="resident" if hopper_train_attention.resident(l, hd) else "stream",
                  **train_attention_geometry_text(g, l, hd, n_pairs),
                  keep="ones" if n_pairs == 1 else "dropout_0.1", fwd_tol=TRAIN_ATTN_FWD_TOL,
                  bwd_tol=TRAIN_ATTN_BWD_TOL, max_abs_err_fwd=f"{fwd_err:.3g}",
                  max_abs_err_bwd=f"{bwd_abs:.3g}",
                  **{f"rel_err_{n}": f"{e:.3g}" for n, e in rel.items()},
                  fwd_same_bits=fwd_same, bwd_same_bits=same)
            check(np.isfinite(fwd_err) and fwd_err <= TRAIN_ATTN_FWD_TOL,
                  f"train_attention forward disagrees with its plain version at G={g} L={l} "
                  f"hd={hd} n_pairs={n_pairs}: {fwd_err}")
            check(all(np.isfinite(e) and e <= TRAIN_ATTN_BWD_TOL for e in rel.values()),
                  f"train_attention backward disagrees with its plain version at G={g} L={l} "
                  f"hd={hd} n_pairs={n_pairs}: {rel}")
            check(same, f"train_attention backward gave other bits on a second launch at G={g} "
                        f"L={l} hd={hd} n_pairs={n_pairs}")
            check(fwd_same, f"train_attention forward gave other bits on a second launch at "
                            f"G={g} L={l} hd={hd} n_pairs={n_pairs}")
            worst_fwd, worst_bwd = max(worst_fwd, fwd_err), max(worst_bwd, bwd_abs)
            del q, k, v, keep, do, out, lse, grads, ref, ref_grads
    return worst_fwd, worst_bwd


# -- the synthesis path ----------------------------------------------------------

def lstm_inputs(t, b, h, n_dir, dtype, seed):
    """Seeded x_proj (T, B, D*4H), w_h (D, H, 4H), b_h (D, 4H) and a ragged
    mask (T, B) with a full row and, for B > 1, a row of length 1."""
    g = torch.Generator().manual_seed(seed)
    xp = torch.randn(t, b, n_dir * 4 * h, generator=g) * 0.5
    wh = torch.randn(n_dir, h, 4 * h, generator=g) * 0.1
    bh = torch.randn(n_dir, 4 * h, generator=g) * 0.1
    lengths = torch.randint(1, t + 1, (b,), generator=g)
    lengths[-1] = 1
    lengths[0] = t
    mask = torch.arange(t)[:, None] < lengths[None, :]
    return [v.to(dtype).cuda() for v in (xp, wh, bh)] + [mask.cuda()]


LSTM_LAYOUTS = (("bidirectional", 2, 0b10), ("forward", 1, 0), ("reverse", 1, 1))


def lstm_fwd_vs_plain():
    """The forward kernel against its plain version at LSTM_CASES, both
    directions in one launch and each alone: ys within F32_TOL (bf16:
    BF16_TOL, h in (-1, 1)); the cell states, unbounded, within the same
    figure relative to max(|c|, 1); the inference launch (no cell states)
    writes the same ys, and a second launch the same bits. Returns the
    largest f32 ys error at the latent RNN's shape."""
    worst = 0.0
    for t, b, h in LSTM_CASES:
        for dtype, tol in FWD_DTYPES:
            errs, bitwise = {}, True
            for name, n_dir, rev_bits in LSTM_LAYOUTS:
                xp, wh, bh, mask = lstm_inputs(t, b, h, n_dir, dtype, seed=t + b + h + n_dir)
                ys, cs = hopper_lstm.lstm_forward(xp, wh, bh, mask, rev_bits, with_cells=True)
                inference, _ = hopper_lstm.lstm_forward(xp, wh, bh, mask, rev_bits)
                ref_ys, ref_cs = hopper_lstm.lstm_forward_reference(xp, wh, bh, mask, rev_bits,
                                                                     with_cells=True)
                bitwise &= repeats_bitwise(lambda: hopper_lstm.lstm_forward(
                    xp, wh, bh, mask, rev_bits, with_cells=True), (ys, cs))
                torch.cuda.synchronize()
                errs[f"ys_{name}"] = (ys.float() - ref_ys.float()).abs().max().item()
                errs[f"cs_{name}"] = rel_err(cs, ref_cs)
                check(torch.equal(ys, inference), f"lstm_fwd without cell states differs at "
                                                  f"{(t, b, h)} {dtype} {name}")
            geo = geometry_fields(b, 2, h, 4, dtype)
            phase("kernel", kernel="lstm_fwd", T=t, B=b, H=h, dtype=str(dtype).split(".")[-1],
                  tol=tol, C=geo["C"], rows=geo["rows"], instance=geo["instance"],
                  one_direction_C=geometry_fields(b, 1, h, 4, dtype)["C"], bitwise=bitwise,
                  **{f"err_{k}": f"{v:.3g}" for k, v in errs.items()})
            check(all(np.isfinite(v) and v <= tol for v in errs.values()),
                  f"lstm_fwd kernel disagrees with its plain version at {(t, b, h)} {dtype}: {errs}")
            check(bitwise, f"lstm_fwd gave other bits on a second launch at {(t, b, h)} {dtype}")
            if dtype == torch.float32 and (t, b, h) == LSTM_SHAPES[0]:
                worst = max(v for k, v in errs.items() if k.startswith("ys_"))
    return worst


def lstm_bwd_vs_plain():
    """The backward kernel against its plain version (dx_proj, dW_h, db_h,
    relative to max(|ref|, 1)) at LSTM_CASES, from the plain forward's ys and
    cell states, both directions in one launch and each alone, f32 within
    BWD_F32_TOL and bf16 within BWD_BF16_TOL, and in f32 against
    torch.autograd through the plain forward; a second launch gives the
    same bits. Returns the largest f32 absolute error at the latent RNN's
    shape and the largest f32 relative one."""
    worst_abs, worst_rel = 0.0, 0.0
    for t, b, h in LSTM_CASES:
        for dtype, tol in BWD_DTYPES:
            errs, abs_errs, bitwise = {}, {}, True
            for name, n_dir, rev_bits in LSTM_LAYOUTS:
                xp, wh, bh, mask = lstm_inputs(t, b, h, n_dir, dtype, seed=2 * t + b + h + n_dir)
                ys, cs = hopper_lstm.lstm_forward_reference(xp, wh, bh, mask, rev_bits,
                                                            with_cells=True)
                gy = torch.randn(t, b, n_dir * h, generator=torch.Generator().manual_seed(b),
                                 device="cpu").to(dtype).cuda()
                got = hopper_lstm.lstm_backward(xp, wh, bh, mask, ys, cs, gy, rev_bits)
                ref = hopper_lstm.lstm_backward_reference(xp, wh, bh, mask, ys, cs, gy, rev_bits)
                bitwise &= repeats_bitwise(lambda: hopper_lstm.lstm_backward(
                    xp, wh, bh, mask, ys, cs, gy, rev_bits), got)
                for part, a, r in zip(("dx", "dW", "db"), got, ref):
                    errs[f"{name}_{part}"] = rel_err(a, r)
                    abs_errs[f"{name}_{part}"] = (a.float() - r.float()).abs().max().item()
                if dtype == torch.float32:
                    params = [v.clone().requires_grad_() for v in (xp, wh, bh)]
                    with torch.enable_grad():
                        out, _ = hopper_lstm.lstm_forward_reference(*params, mask, rev_bits)
                        auto = torch.autograd.grad(out, params, gy)
                    for part, a, r in zip(("dx", "dW", "db"), got, auto):
                        errs[f"{name}_autograd_{part}"] = rel_err(a, r)
                torch.cuda.synchronize()
            geo = bwd_geometry_fields(b, 2, h, 4, dtype)
            phase("kernel", kernel="lstm_bwd", T=t, B=b, H=h, dtype=str(dtype).split(".")[-1],
                  tol=tol, C=geo["C"], rows=geo["rows"], instance=geo["instance"],
                  one_direction_C=bwd_geometry_fields(b, 1, h, 4, dtype)["C"], bitwise=bitwise,
                  **{f"rel_err_{k}": f"{v:.3g}" for k, v in errs.items()})
            check(all(np.isfinite(v) and v <= tol for v in errs.values()),
                  f"lstm_bwd kernel disagrees with its plain version at {(t, b, h)} {dtype}: {errs}")
            check(bitwise, f"lstm_bwd gave other bits on a second launch at {(t, b, h)} {dtype}")
            if dtype == torch.float32:
                worst_rel = max(worst_rel, *errs.values())
                if (t, b, h) == LSTM_SHAPES[0]:
                    worst_abs = max(abs_errs.values())
    return worst_abs, worst_rel


# -- [gru_seq]: the batch-major GRU (row 7) ---------------------------------------

def gru_seq_inputs(b, t, h, seed):
    """Seeded batch-major x_proj (B, T, 3H), w_h (H, 3H), b_h (3H) and a
    ragged mask (B, T) with a full row and (B > 1) a row of length 1."""
    g = torch.Generator().manual_seed(seed)
    xp = torch.randn(b, t, 3 * h, generator=g) * 0.5
    wh = torch.randn(h, 3 * h, generator=g) * 0.1
    bh = torch.randn(3 * h, generator=g) * 0.1
    lengths = torch.randint(1, t + 1, (b,), generator=g)
    lengths[-1] = 1
    lengths[0] = t
    mask = torch.arange(t)[None, :] < lengths[:, None]
    return [v.cuda() for v in (xp, wh, bh, mask)]


def gru_seq_vs_plain():
    """The batch-major kernel against its plain version in f32 within
    F32_TOL at GRU_SEQ_CASES: B = 1, B not a multiple of the tile or the
    cluster's rows, ragged rows (one of length T, one of length 1), T = 1,
    the cluster step at H 16, 20, 128, 136 and 256 and the wide instance at
    512, tiles 1 to 16; then tile 33 with a bf16 x_proj (GRU_SEQ_WIDENED).
    Returns the largest absolute error."""
    worst = 0.0
    for b, t, h, tile in GRU_SEQ_CASES:
        xp, wh, bh, mask = gru_seq_inputs(b, t, h, seed=b + t + h)
        got = hopper_gru.gru_sequence_batch_major(xp, wh, bh, mask, batch_tile=tile)
        ref = hopper_gru.gru_sequence_batch_major_reference(xp, wh, bh, mask)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        geo = geometry_fields(b, 1, h, 3, torch.float32)
        phase("gru_seq", B=b, T=t, H=h, batch_tile=tile, instance=geo["instance"], C=geo["C"],
              rows=geo["rows"], dtype="float32", tol=F32_TOL, max_abs_err=f"{err:.3g}")
        check(np.isfinite(err) and err <= F32_TOL,
              f"gru_seq kernel disagrees with its plain version at B={b} T={t} H={h}: {err}")
        worst = max(worst, err)
    # What JAX takes and the wrapper once refused: a tile above 32 and a bf16
    # x_proj (both sides cast it to f32).
    b, t, h, tile = GRU_SEQ_WIDENED
    xp, wh, bh, mask = gru_seq_inputs(b, t, h, seed=tile)
    xp = xp.bfloat16()
    got = hopper_gru.gru_sequence_batch_major(xp, wh, bh, mask, batch_tile=tile)
    ref = hopper_gru.gru_sequence_batch_major_reference(xp, wh, bh, mask)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    phase("gru_seq", B=b, T=t, H=h, batch_tile=tile, x_proj="bfloat16", dtype="float32",
          tol=F32_TOL, max_abs_err=f"{err:.3g}")
    check(got.dtype == torch.float32 and np.isfinite(err) and err <= F32_TOL,
          f"gru_seq kernel disagrees with its plain version at tile {tile}, bf16 x_proj: {err}")
    worst = max(worst, err)
    check(all(hopper_gru.batch_major_resident(h) for h in (16, 20, HIDDEN, 136, 256))
          and not hopper_gru.batch_major_resident(512), "gru_seq's W_h placement changed")
    xp, wh, bh, mask = gru_seq_inputs(2, 3, hopper_gru.MAX_HIDDEN + 1, seed=0)
    try:
        hopper_gru.gru_sequence_batch_major(xp, wh, bh, mask)
    except ValueError as err:
        phase("gru_seq", H=hopper_gru.MAX_HIDDEN + 1, refused=str(err).replace(" ", "_")[:80])
    else:
        raise RuntimeError("gru_seq took H above MAX_HIDDEN")
    return worst


def gru_seq_path():
    """Row 7's path: as in JAX, no model calls the batch-major kernel; it is
    a measured reference. The path is the two calls it is measured at,
    bench.py's batch (16) and 256, each at T = 128, H = 128, f32, the
    default tile, with the counts set to 0 before and read after: exactly
    one launch each, finite (B, T, H) outputs. Returns the launches."""
    reset_launch_counts()
    outs = [hopper_gru.gru_sequence_batch_major(*gru_seq_inputs(b, BENCH_T, HIDDEN, seed=b))
            for b in GRU_SEQ_TIMED_B]
    torch.cuda.synchronize()
    launches = launch_counts()
    phase("gru_seq", path_launches=launches["gru_seq"],
          shapes=",".join(f"B={b}" for b in GRU_SEQ_TIMED_B))
    check(launches == {**dict.fromkeys(KERNELS, 0), "gru_seq": len(GRU_SEQ_TIMED_B)},
          f"gru_seq path launches {launches}")
    check(all(o.shape == (b, BENCH_T, HIDDEN) and torch.isfinite(o).all().item()
              for o, b in zip(outs, GRU_SEQ_TIMED_B)), "gru_seq path outputs")
    return launches["gru_seq"]


def time_gru_seq():
    """The batch-major kernel at T = 128, H = 128, f32, B = 16 (bench.py's
    shape) and 256, beside its plain version, gru_fwd with one direction on
    the same work (time-major inputs, ready-made), cuDNN's one-direction
    nn.GRU forward and the bound (gru_bound_ms with one direction). Returns
    {B: numbers}."""
    results = {}
    for b in GRU_SEQ_TIMED_B:
        t, h = BENCH_T, HIDDEN
        xp, wh, bh, mask = gru_seq_inputs(b, t, h, seed=b)
        xp_tm, mask_tm = xp.transpose(0, 1).contiguous(), mask.T.contiguous()
        ms = cuda_ms(lambda: hopper_gru.gru_sequence_batch_major(xp, wh, bh, mask), 20)
        plain_ms = cuda_ms(lambda: hopper_gru.gru_sequence_batch_major_reference(xp, wh, bh,
                                                                                  mask), 3)
        gru_fwd_ms = cuda_ms(lambda: hopper_gru.gru_forward(xp_tm, wh[None], bh[None], mask_tm, 0),
                             20)
        cudnn = torch.nn.GRU(h, h, batch_first=True).cuda()
        x = torch.randn(b, t, h, device="cuda")
        with torch.inference_mode():
            library_ms = cuda_ms(lambda: cudnn(x), 20)
        bound_ms, bound_by = gru_bound_ms(t, b, h, 1, 4)
        results[b] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms, gru_fwd_one_direction_ms=gru_fwd_ms,
                          us_per_step=ms * 1e3 / t,
                          geometry=geometry_fields(b, 1, h, 3, torch.float32))
        phase("timing", kernel="gru_seq", T=t, B=b, H=h, directions=1, batch_tile=16,
              dtype="float32", **fmt({k: v for k, v in results[b].items() if k != "geometry"}),
              **results[b]["geometry"])
    return results


# -- [widths]: every widened kernel at widths the resident kernels refuse ---------

def width_errors(kernel, h, dtype):
    """One recurrent kernel ("gru_fwd", "gru_bwd", "lstm_fwd", "lstm_bwd") at
    hidden size h, both directions in one launch (T = 9, B = 5: a partial
    batch tile, ragged rows), against its plain version: the largest error,
    absolute for the forwards' h (relative to max(|c|, 1) for the LSTM's cell
    states), relative to max(|ref|, 1) for the backwards."""
    t, b = 9, 5
    if kernel.startswith("gru"):
        mod, inputs = hopper_gru, gru_inputs(t, b, h, 2, dtype, seed=h)
        ys = mod.gru_forward_reference(*inputs, 0b10)
        if kernel == "gru_fwd":
            return (mod.gru_forward(*inputs, 0b10).float() - ys.float()).abs().max().item()
        gy = torch.randn_like(ys.float()).to(dtype)
        return max(rel_err(a, r) for a, r in zip(mod.gru_backward(*inputs, ys, gy, 0b10),
                                                 mod.gru_backward_reference(*inputs, ys, gy, 0b10)))
    mod, inputs = hopper_lstm, lstm_inputs(t, b, h, 2, dtype, seed=h)
    ys, cs = mod.lstm_forward_reference(*inputs, 0b10, with_cells=True)
    if kernel == "lstm_fwd":
        got_ys, got_cs = mod.lstm_forward(*inputs, 0b10, with_cells=True)
        return max((got_ys.float() - ys.float()).abs().max().item(), rel_err(got_cs, cs))
    gy = torch.randn_like(ys.float()).to(dtype)
    return max(rel_err(a, r) for a, r in zip(mod.lstm_backward(*inputs, ys, cs, gy, 0b10),
                                             mod.lstm_backward_reference(*inputs, ys, cs, gy,
                                                                         0b10)))


def refused(fn):
    """The ValueError's message if fn() raises one, else None."""
    try:
        fn()
    except ValueError as err:
        return str(err)
    return None


def widths():
    """Every widened kernel against its plain version at widths that the
    resident kernels refuse, at the existing limits, with the instance each
    width takes; the new outer bounds refused; one timing of each wide
    instance. Returns {kernel: wide-instance timing}."""
    for kernel in ("gru_fwd", "gru_bwd", "lstm_fwd", "lstm_bwd"):
        mod = hopper_gru if kernel.startswith("gru") else hopper_lstm
        check(mod.resident(kernel, HIDDEN, torch.float32), f"{kernel} left its resident kernel "
                                                           f"at H={HIDDEN}")
        for h in WIDE_RNN_H[kernel[:4]]:
            for dtype, tol in FWD_DTYPES if kernel.endswith("fwd") else BWD_DTYPES:
                fwd = kernel.endswith("fwd")
                err = width_errors(kernel, h, dtype)
                torch.cuda.synchronize()
                instance = "cluster" if mod.resident(kernel, h, dtype) else "wide"
                expected = ({"gru_fwd": GRU_FWD_INSTANCE, "lstm_fwd": LSTM_FWD_INSTANCE}[kernel][h]
                            [dtype != torch.float32] if fwd else BWD_INSTANCE[h])
                check(instance == expected, f"{kernel} takes the {instance} instance at "
                                            f"H={h} {dtype}, expected {expected}")
                phase("widths", kernel=kernel, H=h, dtype=str(dtype).split(".")[-1],
                      instance=instance, tol=tol, err=f"{err:.3g}")
                check(np.isfinite(err) and err <= tol,
                      f"{kernel} disagrees with its plain version at H={h} {dtype}: {err}")
        h = mod.MAX_HIDDEN + 1
        xp, wh, bh, mask = (gru_inputs if kernel.startswith("gru") else lstm_inputs)(
            2, 1, h, 1, torch.float32, seed=0)
        zeros = torch.zeros(2, 1, h, device="cuda")
        reason = refused({"gru_fwd": lambda: hopper_gru.gru_forward(xp, wh, bh, mask, 0),
                          "gru_bwd": lambda: hopper_gru.gru_backward(xp, wh, bh, mask, zeros,
                                                                     zeros, 0),
                          "lstm_fwd": lambda: hopper_lstm.lstm_forward(xp, wh, bh, mask, 0),
                          "lstm_bwd": lambda: hopper_lstm.lstm_backward(xp, wh, bh, mask, zeros,
                                                                        zeros, zeros, 0)}[kernel])
        phase("widths", kernel=kernel, H=h, refused=str(reason).replace(" ", "_")[:80])
        check(reason is not None, f"{kernel} took H={h}")

    for hd, l in WIDE_TRAIN_ATTN:
        for n_pairs in (1, 2):
            q, k, v, keep, do = train_attention_inputs(8, l, n_pairs, seed=hd + l, hd=hd)
            out, lse = hopper_train_attention.fused_causal_attend_fwd(q, k, v, keep, n_pairs)
            grads = hopper_train_attention.fused_causal_attend_bwd(q, k, v, keep, out, lse, do,
                                                                   n_pairs)
            ref = hopper_train_attention.fused_causal_attend_reference(q, k, v, keep, n_pairs)
            ref_grads = hopper_train_attention.fused_causal_attend_bwd_reference(q, k, v, keep,
                                                                                 do, n_pairs)
            torch.cuda.synchronize()
            fwd_err = (out - ref).abs().max().item()
            bwd_err = max(rel_err(a, r) for a, r in zip(grads, ref_grads))
            same = repeats_bitwise(lambda: hopper_train_attention.fused_causal_attend_bwd(
                q, k, v, keep, out, lse, do, n_pairs), grads)
            fwd_same = repeats_bitwise(lambda: hopper_train_attention.fused_causal_attend_fwd(
                q, k, v, keep, n_pairs), (out, lse))
            phase("widths", kernel="train_attention", hd=hd, L=l, G=8, n_pairs=n_pairs,
                  instance="resident" if hopper_train_attention.resident(l, hd) else "stream",
                  **train_attention_geometry_text(8, l, hd, n_pairs),
                  fwd_tol=TRAIN_ATTN_FWD_TOL, bwd_tol=TRAIN_ATTN_BWD_TOL,
                  max_abs_err_fwd=f"{fwd_err:.3g}", rel_err_bwd=f"{bwd_err:.3g}",
                  fwd_same_bits=fwd_same, bwd_same_bits=same)
            check(np.isfinite(fwd_err) and fwd_err <= TRAIN_ATTN_FWD_TOL
                  and np.isfinite(bwd_err) and bwd_err <= TRAIN_ATTN_BWD_TOL,
                  f"train_attention disagrees at hd={hd} L={l}: {fwd_err}, {bwd_err}")
            check(same, f"train_attention backward gave other bits on a second launch at "
                        f"hd={hd} L={l}")
            check(fwd_same, f"train_attention forward gave other bits on a second launch at "
                            f"hd={hd} L={l}")
    hd, l = hopper_train_attention.MAX_HEAD_DIM + 1, 8
    q, k, v, keep, _ = train_attention_inputs(2, l, 1, seed=0, hd=hd)
    reason = refused(lambda: hopper_train_attention.fused_causal_attend(q, k, v, keep, 1))
    phase("widths", kernel="train_attention", hd=hd, L=l,
          refused=str(reason).replace(" ", "_")[:80])
    check(reason is not None, f"train_attention took hd={hd} L={l}")

    for hd in WIDE_FLASH_HD:
        for dtype in (torch.float32, *HALF_DTYPES):
            g = flash_groups(1)["self"]
            k, v, q = flash_inputs(g, dtype, seed=hd, hd=hd)
            errs = {n: flash_excess(hopper_attention.flash_decode_attend(k, v, q, n),
                                    hopper_attention.flash_decode_attend_reference(k, v, q, n))
                    for n in (1, 3, 33, DECODE_T)}
            torch.cuda.synchronize()
            phase("widths", kernel="flash_decode", hd=hd, G=g, dtype=str(dtype).split(".")[-1],
                  rtol=FLASH_RTOL, atol=FLASH_ATOL,
                  **{f"max_abs_err_n{n}": f"{e[1]:.3g}" for n, e in errs.items()})
            check(all(np.isfinite(e[1]) and e[0] <= 0 for e in errs.values()),
                  f"flash_decode disagrees at hd={hd} {dtype}: {errs}")
    k, v, q = flash_inputs(40, torch.float32, seed=0, hd=hopper_attention.MAX_HEAD_DIM + 1)
    reason = refused(lambda: hopper_attention.flash_decode_attend(k, v, q, 1))
    phase("widths", kernel="flash_decode", hd=hopper_attention.MAX_HEAD_DIM + 1,
          refused=str(reason).replace(" ", "_")[:80])
    check(reason is not None, "flash_decode took hd above MAX_HEAD_DIM")
    return time_wide_instances()


def bwd_timing(kernel, h):
    """One recurrent backward ("gru_bwd" or "lstm_bwd") at T = 128, B = 16,
    H = h, both directions, f32: (ms, cuDNN's backward alone at that shape,
    the instance the width takes)."""
    t, b = BENCH_T, BENCH_B
    if kernel == "gru_bwd":
        mod, rnn, inputs = hopper_gru, torch.nn.GRU, gru_inputs(t, b, h, 2, torch.float32, seed=7)
        ys = hopper_gru.gru_forward(*inputs, 0b10)
        ms = cuda_ms(lambda: hopper_gru.gru_backward(*inputs, ys, ys, 0b10), 5)
    else:
        mod, rnn, inputs = hopper_lstm, torch.nn.LSTM, lstm_inputs(t, b, h, 2, torch.float32,
                                                                   seed=7)
        ys, cs = hopper_lstm.lstm_forward(*inputs, 0b10, with_cells=True)
        ms = cuda_ms(lambda: hopper_lstm.lstm_backward(*inputs, ys, cs, ys, 0b10), 5)
    instance = "cluster" if mod.resident(kernel, h, torch.float32) else "wide"
    return ms, cudnn_bwd_ms(rnn, t, b, h)[0], instance


def lstm_fwd_timing(h):
    """lstm_fwd at T = 128, B = 16, H = h, both directions, f32: (ms, cuDNN's
    nn.LSTM forward at that shape, the instance the width takes, checked
    against LSTM_FWD_INSTANCE)."""
    t, b = BENCH_T, BENCH_B
    xp, wh, bh, mask = lstm_inputs(t, b, h, 2, torch.float32, seed=7)
    ms = cuda_ms(lambda: hopper_lstm.lstm_forward(xp, wh, bh, mask, 0b10), 5)
    cudnn = torch.nn.LSTM(h, h, bidirectional=True).cuda()
    x = torch.randn(t, b, h, device="cuda")
    with torch.inference_mode():
        library_ms = cuda_ms(lambda: cudnn(x), 5)
    instance = "cluster" if hopper_lstm.resident("lstm_fwd", h, torch.float32) else "wide"
    check(instance == LSTM_FWD_INSTANCE[h][0], f"lstm_fwd at H={h} f32 takes the {instance} "
                                               f"instance, expected {LSTM_FWD_INSTANCE[h][0]}")
    return ms, library_ms, instance


def time_wide_instances():
    """Each wide instance at one shape, f32, beside one PyTorch call that
    computes the same function there (a yardstick the port never calls):
    gru_fwd and lstm_fwd at H = 512 (T = 128, B = 16, both directions;
    cuDNN's nn.GRU and nn.LSTM forward); gru_bwd and lstm_bwd at H = 512 (the
    same T, B and directions; cuDNN's nn.GRU and nn.LSTM backward timed
    alone); the decode at hd = 128 (the B = 12 cross-channel G, 128 rows;
    scaled_dot_product_attention over (G, 1, 1, hd) x (G, 1, S, hd)). Beside
    them, under keys of their own, the cluster steps at H = 256 (the width
    the wide instances ran at until the cluster steps took it) with cuDNN
    there: gru_fwd's, gru_bwd's, lstm_bwd's and lstm_fwd's."""
    t, b, h = BENCH_T, BENCH_B, WIDE_TIMED_H
    results, library, h256 = {}, {}, {}
    xp, wh, bh, mask = gru_inputs(t, b, h, 2, torch.float32, seed=7)
    check(hopper_gru.resident("gru_fwd", h, torch.float32),
          f"gru_fwd at H={h} f32 was expected to take its cluster step")
    cluster_ms = cuda_ms(lambda: hopper_gru.gru_forward(xp, wh, bh, mask, 0b10), 5)
    cudnn = torch.nn.GRU(h, h, bidirectional=True).cuda()
    x = torch.randn(t, b, h, device="cuda")
    with torch.inference_mode():
        library["gru_fwd_h256"] = cuda_ms(lambda: cudnn(x), 5)
    h256["lstm_fwd"] = lstm_fwd_timing(h)
    results["lstm_fwd"], library["lstm_fwd"], _ = lstm_fwd_timing(WIDE_TIMED_LSTM_FWD_H)
    for name in ("gru_bwd", "lstm_bwd"):
        results[name], library[name], instance = bwd_timing(name, WIDE_TIMED_BWD_H)
        check(instance == "wide", f"{name} at H={WIDE_TIMED_BWD_H} f32 was expected to take "
                                  f"its wide instance")
        h256[name] = bwd_timing(name, h)
    h_fwd = WIDE_TIMED_GRU_FWD_H
    check(not hopper_gru.resident("gru_fwd", h_fwd, torch.float32),
          f"gru_fwd at H={h_fwd} f32 was expected to take its wide instance")
    xp, wh, bh, mask = gru_inputs(t, b, h_fwd, 2, torch.float32, seed=7)
    results["gru_fwd"] = cuda_ms(lambda: hopper_gru.gru_forward(xp, wh, bh, mask, 0b10), 5)
    cudnn = torch.nn.GRU(h_fwd, h_fwd, bidirectional=True).cuda()
    x = torch.randn(t, b, h_fwd, device="cuda")
    with torch.inference_mode():
        library["gru_fwd"] = cuda_ms(lambda: cudnn(x), 5)
    del xp, wh, bh, mask, cudnn, x
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g_flash = flash_groups(12)["inter"]
    k, v, q = flash_inputs(g_flash, torch.float32, seed=7, hd=WIDE_TIMED_FLASH_HD)
    results["flash_decode"] = cuda_ms(lambda: hopper_attention.flash_decode_attend(k, v, q,
                                                                                    DECODE_T), 20)
    sdpa_in = (q.T.reshape(g_flash, 1, 1, WIDE_TIMED_FLASH_HD).contiguous(),
               k.permute(2, 0, 1)[:, None].contiguous(), v.permute(2, 0, 1)[:, None].contiguous())
    library["flash_decode"] = cuda_ms(lambda: sdpa(*sdpa_in, scale=1.0), 20)
    shapes = {"gru_fwd": f"T={t},B={b},H={h_fwd},directions=2",
              **{k: f"T={t},B={b},H={WIDE_TIMED_BWD_H},directions=2"
                 for k in ("gru_bwd", "lstm_bwd")},
              "lstm_fwd": f"T={t},B={b},H={WIDE_TIMED_LSTM_FWD_H},directions=2",
              "flash_decode": f"G={g_flash},S={DECODE_T},hd={WIDE_TIMED_FLASH_HD}"}
    h256_shape = f"T={t},B={b},H={h},directions=2"
    phase("timing", kernel="gru_fwd", instance="cluster", shape=h256_shape, dtype="float32",
          ms=f"{cluster_ms:.6g}", library_ms=f"{library['gru_fwd_h256']:.6g}")
    for name, (ms, lib_ms, instance) in h256.items():
        phase("timing", kernel=name, instance=instance, shape=h256_shape, dtype="float32",
              ms=f"{ms:.6g}", library_ms=f"{lib_ms:.6g}")
    for name, ms in results.items():
        phase("timing", kernel=name, instance="wide", shape=shapes[name], dtype="float32",
              ms=f"{ms:.6g}", library_ms=f"{library[name]:.6g}")
    wide = {name: {"wide_ms": ms, "wide_shape": shapes[name], "wide_library_ms": library[name]}
            for name, ms in results.items()}
    wide["gru_fwd"].update(h256_cluster_ms=cluster_ms, h256_cluster_shape=h256_shape,
                           h256_cluster_library_ms=library["gru_fwd_h256"])
    for name, (ms, lib_ms, instance) in h256.items():
        wide[name].update({f"h256_{instance}_ms": ms, f"h256_{instance}_shape": h256_shape,
                           f"h256_{instance}_library_ms": lib_ms})
    return wide


class Sentences:
    """Seeded in-memory sentences with the SynthesisDataset interface."""

    def __init__(self, n, articulators, seed):
        rng = np.random.default_rng(seed)
        self.articulators = sorted(articulators)
        self.data = []
        for i, n_tok in enumerate(rng.integers(20, 129, n)):
            tokens = rng.integers(0, VOCAB, n_tok).astype(np.int32)
            self.data.append({"sentence_name": f"S{i:03d}", "subject": "subject1",
                              "phonemes": [f"p{t}" for t in tokens], "tokens": tokens})

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index):
        item = self.data[index]
        return {**item, "length": len(item["tokens"])}


def bench_grid():
    """bench.py's semipolar grid."""
    return build_semipolar_grid(center=(0.5, 0.5), theta_rad=np.deg2rad(30.0),
                                omega_rad=np.deg2rad(-30.0), linear_step=0.05,
                                polar_step_rad=np.deg2rad(5.0)).astype(np.float32)


def bench_step(device):
    """make_synthesis_step + tube_area_function at the bench.py shape."""
    model = ArtSpeech(VOCAB, len(TUBE_ARTICULATORS), generator=torch.Generator().manual_seed(1),
                      device=device)
    step, arts = make_synthesis_step(model, TUBE_ARTICULATORS, device=device)
    grid = torch.as_tensor(bench_grid(), device=device)

    def run(tokens, lengths):
        out = step(tokens, lengths)
        with torch.inference_mode():
            area = tube_area_function(out["internal_wall"], out["external_wall"],
                                      semipolar_grid=grid)
        return out, area

    return run


def main_path(tmp):
    """Returns the launches it made."""
    model = ArtSpeech(VOCAB, len(RECOGNITION_ARTICULATORS), generator=torch.Generator().manual_seed(0))
    dataset = Sentences(32, RECOGNITION_ARTICULATORS, seed=0)
    bench = bench_step(None)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, VOCAB, (BENCH_B, BENCH_T)).astype(np.int32)
    lengths = np.full(BENCH_B, BENCH_T, np.int32)
    torch.cuda.synchronize()

    hopper_gru.launches = 0
    t0 = time.perf_counter()
    written = synthesize_corpus(model, dataset, tmp, DATASET_CONFIG["artspeech2"], batch_size=8)
    out, area = bench(tokens, lengths)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = hopper_gru.launches

    n_batches = -(-len(dataset) // 8)
    expected = 2 * (n_batches + 1)  # one launch per BiGRU layer (both directions)
    phase("main", sentences=len(written), batches=n_batches, seconds=f"{seconds:.3f}",
          gru_launches=launches, expected=expected)
    check(launches == expected, f"GRU kernel launched {launches} times, expected {expected}")

    # The corpus: every file of every frame, finite.
    n_frames = sum(len(it["tokens"]) for it in dataset.data)
    n_npy = n_txt = 0
    for d in written:
        for sub, ext in (("inference_contours", ".npy"), ("air_column", ".npy"), ("xarticul", ".txt")):
            for name in os.listdir(os.path.join(d, sub)):
                path = os.path.join(d, sub, name)
                if ext == ".npy":
                    check(np.isfinite(np.load(path)).all(), f"non-finite values in {path}")
                    n_npy += 1
                else:
                    check(np.isfinite(np.loadtxt(path)).all(), f"non-finite values in {path}")
                    n_txt += 1
    check(n_npy == n_frames * (len(TUBE_ARTICULATORS) + 1), f"{n_npy} npy files for {n_frames} frames")
    check(n_txt == n_frames, f"{n_txt} xarticul files for {n_frames} frames")
    phase("main", corpus_frames=n_frames, npy_files=n_npy, xarticul_files=n_txt, finite=True)

    frames = BENCH_B * BENCH_T
    check(tuple(out["contours"].shape) == (BENCH_B, BENCH_T, 11, 2, 50), "contours shape")
    check(tuple(out["internal_wall"].shape) == (BENCH_B, BENCH_T, 100, 2), "wall shape")
    check(tuple(area.shape) == (BENCH_B, BENCH_T, 2, 200), "area function shape")
    for key, value in (*out.items(), ("area", area)):
        check(bool(torch.isfinite(value).all()), f"non-finite {key}")
    phase("main", bench_frames=frames, area_shape=tuple(area.shape), finite=True)
    return launches


def against_cpu():
    """The bench-shape path on the card against the same path on the CPU
    (plain GRU) on a small input; same seeded weights on both. The area
    function is compared on the same (the card's) walls: which wall crossings
    pair up is discrete, so walls a few ulps apart may pick another pair."""
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, VOCAB, (2, 32)).astype(np.int32)
    lengths = np.array([32, 17], np.int32)
    gpu_out, gpu_area = bench_step(None)(tokens, lengths)
    cpu_out, _ = bench_step("cpu")(tokens, lengths)
    errs = {k: (gpu_out[k].cpu() - cpu_out[k]).abs().max().item() for k in cpu_out}
    cpu_area = tube_area_function(gpu_out["internal_wall"].cpu(), gpu_out["external_wall"].cpu(),
                                  semipolar_grid=torch.as_tensor(bench_grid()))
    errs["area"] = (gpu_area.cpu() - cpu_area).abs().max().item()
    phase("main", against_cpu_tol=1e-4, **{f"max_abs_err_{k}": f"{v:.3g}" for k, v in errs.items()})
    check(all(v <= 1e-4 for v in errs.values()), f"card and CPU disagree: {errs}")


# -- the training path -----------------------------------------------------------

def smooth_contours(length, rng, n_art=len(RECOGNITION_ARTICULATORS)):
    """(length, n_art, 2, 50) smooth contours in [0, 1]: per articulator an
    arc of 50 points whose centre drifts slowly over the frames."""
    theta = np.linspace(0.0, np.pi, 50)
    frames = np.arange(length)[:, None, None]
    centre = rng.uniform(0.3, 0.7, (1, n_art, 2))
    radius = rng.uniform(0.05, 0.2, (1, n_art, 2))
    phase_ = rng.uniform(0.0, 2 * np.pi, (1, n_art, 1))
    drift = 0.1 * np.sin(2 * np.pi * frames / rng.uniform(20, 60) + phase_)
    x = centre[..., 0:1] + drift + radius[..., 0:1] * np.cos(theta)
    y = centre[..., 1:2] - drift + radius[..., 1:2] * np.sin(theta)
    return np.clip(np.stack([x, y], axis=2), 0.0, 1.0).astype(np.float32)


class Corpus:
    """Seeded in-memory sentences of 20-128 frames (or of the ``lengths``
    given) with the ArtSpeechDataset item interface and smooth target
    contours."""

    def __init__(self, n, seed, lengths=None):
        rng = np.random.default_rng(seed)
        self.data = []
        for i, length in enumerate(rng.integers(20, 129, n) if lengths is None else lengths):
            tokens = rng.integers(0, VOCAB, length).astype(np.int32)
            self.data.append({
                "sentence_name": f"S{i:03d}", "tokens": tokens,
                "targets": smooth_contours(length, rng), "phonemes": [f"p{t}" for t in tokens],
                "references": np.zeros((length, 1, 2, 50), np.float32),
                "critical_masks": np.zeros((0, length), np.int32),
                "frame_ids": [f"{f:04d}" for f in range(length)],
                "voicing": np.zeros(length, np.float32), "length": int(length)})

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index):
        return self.data[index]


def thesis_state(device, seed=0, dropout=TRAIN["dropout"], lr=TRAIN["lr"]):
    model = ArtSpeech(VOCAB, len(RECOGNITION_ARTICULATORS), dropout=dropout,
                      generator=torch.Generator().manual_seed(seed), device=device)
    return state.create_train_state(model, lr, TRAIN["wd"])


def parameters(st):
    return {k: v.detach().clone() for k, v in st.model.state_dict().items()}


def train_path(tmp):
    """fit for 2 epochs at thesis width, its checkpoints and a resume; the
    launch counts of all three kernels. Returns those counts."""
    train_loader = BucketedLoader(Corpus(TRAIN["n_train"], seed=1), TRAIN["batch"], seed=0)
    valid_loader = BucketedLoader(Corpus(TRAIN["n_valid"], seed=2), TRAIN["batch"], shuffle=False)
    train_step = make_artspeech_train_step(TO_MM)
    eval_step = make_artspeech_eval_step(TO_MM)
    steps = {"train": 0, "eval": 0}

    def counted_train(st, batch, generator):
        steps["train"] += 1
        return train_step(st, batch, generator)

    def counted_eval(st, batch):
        steps["eval"] += 1
        return eval_step(st, batch)

    st = thesis_state(None)
    torch.cuda.synchronize()
    hopper_gru.launches = hopper_gru.bwd_launches = hopper_p2cp.launches = 0
    t0 = time.perf_counter()
    result = loop.fit(st, train_loader, valid_loader, counted_train, counted_eval,
                      TRAIN["epochs"], tmp, patience=30)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {"gru_fwd": hopper_gru.launches, "gru_bwd": hopper_gru.bwd_launches,
              "p2cp": hopper_p2cp.launches}
    expected = {"gru_fwd": 2 * (steps["train"] + steps["eval"]), "gru_bwd": 2 * steps["train"],
                "p2cp": steps["eval"]}
    phase("train", epochs=len(result.history), train_steps=steps["train"],
          eval_steps=steps["eval"], seconds=f"{seconds:.3f}",
          **{f"{k}_launches": v for k, v in counts.items()},
          **{f"{k}_expected": v for k, v in expected.items()})
    check(counts == expected, f"kernel launches {counts}, expected {expected}")
    for record in result.history:
        phase("train", **fmt({k: v for k, v in record.items()}))
        check(all(np.isfinite(v) for k, v in record.items() if k != "best"),
              f"non-finite metric in {record}")
    check(len(result.history) == TRAIN["epochs"], "fit stopped early")
    for sub in ("best/state.pt", "best/aux.json", "last/state.pt", "last/aux.json", "best_model"):
        check(os.path.isfile(os.path.join(tmp, sub)), f"fit wrote no {sub}")

    final = parameters(result.state)
    restored, _ = restore_checkpoint(os.path.join(tmp, "last"), thesis_state(None, seed=7))
    same = all(torch.equal(v, final[k]) for k, v in parameters(restored).items())
    resumed = loop.fit(thesis_state(None, seed=7), train_loader, valid_loader, train_step,
                       eval_step, TRAIN["epochs"] + 1, tmp, resume=True)
    phase("train", restored_from_last_equal=same,
          resumed_epochs=[r["epoch"] for r in resumed.history], resumed_step=resumed.state.step)
    check(same, "restoring last/ does not give fit's final parameters")
    check([r["epoch"] for r in resumed.history] == [TRAIN["epochs"]], "resume did not continue")
    check(resumed.state.step == result.state.step + steps["train"] // TRAIN["epochs"],
          "resumed step count")
    return counts


def fixed_batch(b, t, seed, device, ragged=True):
    """One seeded (B, T) batch; ragged lengths in [T/2, T] (the first T), or
    every frame valid."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(t // 2, t + 1, b) if ragged else np.full(b, t)
    lengths[0] = t
    mask = np.arange(t)[None, :] < lengths[:, None]
    batch = {"tokens": np.where(mask, rng.integers(0, VOCAB, (b, t)), 0).astype(np.int32),
             "targets": np.stack([smooth_contours(t, rng) for _ in range(b)])
             * mask[:, :, None, None, None],
             "lengths": lengths.astype(np.int32)}
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def loss_falls():
    st = thesis_state(None, lr=1e-3)
    batch = fixed_batch(TRAIN["batch"], 128, seed=3, device="cuda", ragged=False)
    step = make_artspeech_train_step(TO_MM)
    gen = torch.Generator(device="cuda").manual_seed(0)
    losses = [step(st, batch, gen)["loss"].item() for _ in range(20)]
    phase("train", fixed_batch_lr=1e-3, loss_first=f"{losses[0]:.6g}",
          loss_last=f"{losses[-1]:.6g}", ratio=f"{losses[-1] / losses[0]:.4f}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"loss did not fall: {losses}")


def train_against_cpu():
    """One train step, dropout 0, same weights and batch (B=2, T=32, ragged),
    on the card and on the CPU. Within 1e-4 relative (max |diff| / max |cpu
    value|, per tensor): the metrics, every gradient, AdamW's two moments
    after the step (exp_avg = 0.1 g, exp_avg_sq = 0.001 g^2) on every
    component, and every parameter after the step where |g| >= 100 * eps.

    AdamW's first update of a component is lr * g / (|g| + eps), eps = 1e-8,
    so where |g| is near eps (dead ReLU units give exact zeros and rounding
    noise) a 1e-9 difference in g moves the update by up to lr: the
    parameters are compared where |g| >= 100 * eps, the moments (which carry
    no eps) everywhere, and the unmasked parameter figure is printed."""
    batch = fixed_batch(2, 32, seed=4, device="cpu")
    out = {}
    for device in ("cuda", "cpu"):
        st = thesis_state(device, dropout=0.0)
        metrics = make_artspeech_train_step(TO_MM, with_p2cp=True, device=device)(
            st, {k: v.to(device) for k, v in batch.items()})
        named = list(st.model.named_parameters())
        out[device] = ({k: v.cpu() for k, v in metrics.items()},
                       {n: p.grad.cpu() for n, p in named},
                       {n: p.detach().cpu() for n, p in named},
                       {(n, m): st.optimizer.state[p][m].cpu()
                        for n, p in named for m in ("exp_avg", "exp_avg_sq")})

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()

    eps = 1e-8
    cpu_grads, cpu_params, cpu_moments = out["cpu"][1], out["cpu"][2], out["cpu"][3]
    errs = {f"metric_{k}": rel(out["cuda"][0][k], v) for k, v in out["cpu"][0].items()}
    errs["grads_max"] = max(rel(out["cuda"][1][n], g) for n, g in cpu_grads.items())
    for m in ("exp_avg", "exp_avg_sq"):
        errs[f"{m}_max"] = max(rel(out["cuda"][3][key], v)
                               for key, v in cpu_moments.items() if key[1] == m)
    stable_err, near_eps_count = 0.0, 0
    for n, p in cpu_params.items():
        diff = (out["cuda"][2][n] - p).abs()
        stable = cpu_grads[n].abs() >= 100 * eps
        stable_err = max(stable_err, (diff[stable].max() / p.abs().max()).item()
                         if stable.any() else 0.0)
        near_eps_count += int((~stable).sum())
    errs["params_max_where_g_ge_100eps"] = stable_err
    all_params = max(rel(out["cuda"][2][n], p) for n, p in cpu_params.items())
    phase("train", against_cpu_tol=1e-4, **{f"rel_err_{k}": f"{v:.3g}" for k, v in errs.items()},
          rel_err_params_max_all=f"{all_params:.3g}", components_g_below_100eps=near_eps_count)
    check(all(v <= 1e-4 for v in errs.values()), f"card and CPU train steps disagree: {errs}")


# -- data parallelism ------------------------------------------------------------

PARALLEL = dict(batch=TRAIN["batch"], t=128, dummies=3, steps=3, gloo_steps=2, tol=1e-6,
                gloo_rel=1e-4, gloo_abs=1e-5)
PARALLEL_KERNELS = ("gru_fwd", "gru_bwd", "p2cp")
#: The transformer on a (data 1, model 2) mesh of the two gloo ranks:
#: train_transformer.yaml's widths and dropout, the thesis batch at T = 128
#: (ragged), 3 updates; each rank runs the pair attention on its 5 x 9 pairs.
#: Bounds against the one-device step (model_axis_against_one_device): the
#: first update's metrics (the same weights and masks) 1e-5 relative, its
#: gradients 1e-2 (global relative L2), the later updates' metrics 1e-3 and
#: parameters 2 lr a step.
MODEL_AXIS_TF = dict(batch=TRAIN["batch"], t=TRAIN_T, steps=3, pairs=45, first_metrics=1e-5,
                     first_grads=1e-2, later_metrics=1e-3, params_lr_per_step=2.0)
MODEL_AXIS_KERNELS = ("train_attention_fwd", "train_attention_bwd", "p2cp")
#: The reference ArtSpeech import: a seeded state dict in the reference's key
#: layout at the thesis widths; the model on the card against the CPU.
REFERENCE_IMPORT = dict(b=12, t=128, tol=1e-5)


def parallel_batch():
    """train_model_free.yaml's batch (B = 12) at T = 128, ragged, the last
    PARALLEL["dummies"] rows dummies of length 0, as numpy arrays."""
    batch = {k: v.numpy() for k, v in fixed_batch(PARALLEL["batch"], PARALLEL["t"], seed=11,
                                                   device="cpu").items()}
    dummies = slice(PARALLEL["batch"] - PARALLEL["dummies"], None)
    batch["lengths"][dummies] = 0
    batch["tokens"][dummies] = 0
    batch["targets"][dummies] = 0.0
    return batch


def parallel_steps(st, step, batch, n_steps, mesh=None):
    """``n_steps`` steps; the metrics of each (floats), and each step's
    gradients on the host."""
    metrics, grads = [], []
    for i in range(n_steps):
        generator = loop.epoch_generator(0, i, "cuda", 0 if mesh is None else mesh.data_index)
        m = step(st, batch, generator) if mesh is None else \
            run_distributed_step(step, st, batch, generator, mesh)
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append({n: p.grad.detach().cpu() for n, p in st.model.named_parameters()})
    torch.cuda.synchronize()
    return metrics, grads


def parallel_rank(rank, host, tf_host, fit_dir):
    """One of two gloo ranks on cuda:0: the thesis step at dropout 0 over a
    two-rank data mesh (its metrics, its launches and (rank 0) parameters
    and each step's summed gradients); then the model axis (model_axis_rank)."""
    mesh = make_mesh()
    st = distribute_state(thesis_state(None, dropout=0.0), mesh)
    step = make_artspeech_train_step(TO_MM, with_p2cp=True, mesh=mesh)
    reset_launch_counts()
    metrics, grads = parallel_steps(st, step, host, PARALLEL["gloo_steps"], mesh)
    counts = {k: launch_counts()[k] for k in PARALLEL_KERNELS}
    params = {k: v.cpu() for k, v in parameters(st).items()} if rank == 0 else None
    return (metrics, counts, params, mesh.shape, grads if rank == 0 else None,
            model_axis_rank(rank, tf_host, fit_dir))


def model_axis_rank(rank, tf_host, fit_dir):
    """The (data 1, model 2) mesh of the two ranks: the thesis transformer's
    train step (its channel stacks and heads split, 3 updates, dropout 0.1),
    with its launches, the training attention's (G, n_pairs) and (rank 0)
    the whole parameters; then ``fit`` of the thesis model for one epoch
    (its heads split) into ``fit_dir``."""
    mesh = make_mesh(model_parallel=2)
    st = transformer_state(None)
    whole_shapes = {n: p.shape for n, p in st.model.named_parameters()}
    distribute_state(st, mesh)
    sliced = [n for n, p in st.model.named_parameters() if p.shape != whole_shapes[n]]
    step = make_transformer_train_step(TO_MM, with_p2cp=True, mesh=mesh)
    attend, calls = hopper_train_attention.fused_causal_attend, []

    def recorded(q, k, v, keep, n_pairs):
        calls.append((q.shape[0], q.shape[1], q.shape[2], n_pairs))
        return attend(q, k, v, keep, n_pairs)

    hopper_train_attention.fused_causal_attend = recorded
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    metrics, first_grads = [], None
    try:
        for i in range(MODEL_AXIS_TF["steps"]):
            m = run_distributed_step(step, st, tf_host, loop.epoch_generator(0, i, "cuda", 0), mesh)
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:  # the first step's gradients, whole (a collective)
                grads = {n: p.grad for n, p in st.model.named_parameters()}
                grads.update(zip(sliced, gather_leading_slices(
                    [grads[n] for n in sliced], mesh.model_group, mesh.model_index, 2)))
                first_grads = {n: g.cpu() for n, g in grads.items()} if rank == 0 else None
    finally:
        hopper_train_attention.fused_causal_attend = attend
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {k: launch_counts()[k] for k in MODEL_AXIS_KERNELS}
    whole, _ = whole_state_dicts(st.model)  # a collective: both ranks
    stack = "decoder_layers.0.inter.pairs.dense0_kernel"
    out = {"coords": mesh.coords, "metrics": metrics, "counts": counts, "calls": calls,
           "seconds": seconds, "first_grads": first_grads, "sliced": len(sliced), "stack_rows": {n: p.shape[0] for n, p in st.model.named_parameters()
                                              if n in (stack, "predictors.dense0_kernel")},
           "params": {k: v.cpu() for k, v in whole.items()} if rank == 0 else None}
    del st, whole
    train_loader = BucketedLoader(Corpus(TRAIN["n_train"], seed=1), TRAIN["batch"], seed=0)
    valid_loader = BucketedLoader(Corpus(TRAIN["n_valid"], seed=2), TRAIN["batch"], shuffle=False)
    torch.cuda.synchronize()
    reset_launch_counts()
    fitted = loop.fit(thesis_state(None), train_loader, valid_loader, None, None, 1, fit_dir,
                      mesh=mesh,
                      train_step_factory=lambda m: make_artspeech_train_step(TO_MM, mesh=m),
                      eval_step_factory=lambda m: make_artspeech_eval_step(TO_MM, mesh=m))
    torch.cuda.synchronize()
    out["fit"] = {"history": fitted.history, "counts": launch_counts(),
                  "head_rows": fitted.state.model.decoder.dense0_kernel.shape[0]}
    return out


def parallel_one_rank(host):
    """The mesh step through a one-rank NCCL group against the group-free
    step (3 updates, dropout 0.1): equal within PARALLEL["tol"], the same
    launches; both timed in turns, and the gradient all-reduce alone.
    Returns the group step's launch counts (the main path's of this phase)."""
    initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    try:
        mesh = make_mesh()
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in host.items()}
        runs = {}
        for label, m in (("group_free", None), ("nccl_group", mesh)):
            st = thesis_state(None)
            if m is not None:
                distribute_state(st, m)
            step = make_artspeech_train_step(TO_MM, with_p2cp=True, mesh=m)
            torch.cuda.synchronize()
            reset_launch_counts()
            metrics, _ = parallel_steps(st, step, batch, PARALLEL["steps"], m)
            runs[label] = dict(metrics=metrics, params=parameters(st), st=st, step=step,
                               counts={k: launch_counts()[k] for k in PARALLEL_KERNELS})
        free, group = runs["group_free"], runs["nccl_group"]
        err = max(rel_err(group["params"][k], v) for k, v in free["params"].items())
        metric_err = max(abs(g[k] - f[k]) / max(abs(f[k]), 1e-30)
                         for g, f in zip(group["metrics"], free["metrics"])
                         for k in ("loss", "p2cp_mm"))
        gen = torch.Generator(device="cuda").manual_seed(0)
        times = {}
        for label in ("group_free", "nccl_group", "nccl_group", "group_free"):
            r = runs[label]
            times.setdefault(label, []).append(host_ms(lambda: r["step"](r["st"], batch, gen), 10))
        grads = [p.grad for p in group["st"].model.parameters()]
        extras = [torch.zeros((), device="cuda") for _ in range(3)]
        allreduce_ms = cuda_ms(lambda: all_reduce_flat(grads + extras, mesh.data_group), 20)
        step_ms = {k: min(v) for k, v in times.items()}
        phase("parallel", case="one_rank_nccl", steps=PARALLEL["steps"],
              shape=f"B={PARALLEL['batch']},T={PARALLEL['t']},H={HIDDEN},dummies="
                    f"{PARALLEL['dummies']},dropout={TRAIN['dropout']}",
              max_rel_err_params=f"{err:.3g}", max_rel_err_metrics=f"{metric_err:.3g}",
              manual_spmd=[group["metrics"][0]["manual_spmd"], free["metrics"][0]["manual_spmd"]],
              **{f"{k}_launches": [group["counts"][k], free["counts"][k]]
                 for k in PARALLEL_KERNELS},
              step_ms_group_free=f"{step_ms['group_free']:.6g}",
              step_ms_nccl_group=f"{step_ms['nccl_group']:.6g}",
              step_ms_turns=";".join(f"{k}={','.join(f'{t:.6g}' for t in v)}"
                                     for k, v in times.items()),
              grad_allreduce_ms=f"{allreduce_ms:.6g}",
              grad_allreduce_share=f"{allreduce_ms / step_ms['nccl_group']:.4f}",
              grad_elements=sum(g.numel() for g in grads))
        check(err <= PARALLEL["tol"] and metric_err <= PARALLEL["tol"],
              f"one-rank NCCL mesh step differs from the group-free step: {err:.3g}, "
              f"{metric_err:.3g}")
        check(group["counts"] == free["counts"] and all(group["counts"].values()),
              f"launches differ: {group['counts']} vs {free['counts']}")
        check(group["metrics"][0]["manual_spmd"] == 1.0 and free["metrics"][0]["manual_spmd"] == 0.0,
              "manual_spmd markers")
        return group["counts"]
    finally:
        torch.distributed.destroy_process_group()


def parallel_two_gloo_ranks(host):
    """Two gloo ranks sharing cuda:0 (dropout 0) against the one-rank step;
    in the same spawn, the model axis (model_axis_against_one_device).
    Returns the model-axis launches of both ranks together."""
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in host.items()}
    st = thesis_state(None, dropout=0.0)
    one, grads = parallel_steps(st, make_artspeech_train_step(TO_MM, with_p2cp=True), batch,
                                PARALLEL["gloo_steps"])
    one_params = parameters(st)
    del st
    tf_host = {k: v.numpy() for k, v in fixed_batch(MODEL_AXIS_TF["batch"], MODEL_AXIS_TF["t"],
                                                     seed=13, device="cpu").items()}
    st = transformer_state(None)
    tf_one, tf_grads = parallel_steps(
        st, make_transformer_train_step(TO_MM, with_p2cp=True),
        {k: torch.as_tensor(v, device="cuda") for k, v in tf_host.items()},
        MODEL_AXIS_TF["steps"])
    tf_one_params = parameters(st)
    shape = {"layers": st.model.num_layers, "heads": st.model.num_heads}
    del st
    fit_dir = tempfile.mkdtemp()
    t0 = time.perf_counter()
    try:
        results = spawn(2, parallel_rank, host, tf_host, fit_dir, device="cuda",
                        backend="gloo", timeout_s=300.0)
        seconds = time.perf_counter() - t0
        counts = model_axis_against_one_device([r[5] for r in results], tf_one, tf_grads,
                                               tf_one_params, fit_dir, **shape)
    finally:
        shutil.rmtree(fit_dir, ignore_errors=True)
    metric_err = max(abs(m[i][k] - one[i][k]) / max(abs(one[i][k]), 1e-30)
                     for m, *_ in results for i in range(len(one)) for k in ("loss", "p2cp_mm"))
    stable_err, below, all_err = stable_param_err(results[0][2], one_params, grads)
    # Each step's gradients summed over the ranks (averaged ones would pass the
    # parameter check: AdamW's first updates do not see a common scale);
    # the first step's, from the same parameters, within 1e-5 max(|g|, 1).
    grad_errs = [max(((got[n] - g).abs().max() / max(g.abs().max().item(), 1.0)).item()
                     for n, g in ref.items())
                 for got, ref in zip(results[0][4], grads)]
    expected = {"gru_fwd": 2 * PARALLEL["gloo_steps"], "gru_bwd": 2 * PARALLEL["gloo_steps"],
                "p2cp": PARALLEL["gloo_steps"]}
    phase("parallel", case="two_gloo_ranks_cuda0", steps=PARALLEL["gloo_steps"],
          mesh=results[0][3], seconds=f"{seconds:.3f}",
          max_rel_err_metrics=f"{metric_err:.3g}", max_abs_err_params=f"{stable_err:.3g}",
          max_abs_err_params_all=f"{all_err:.3g}", components_g_below_100eps=below,
          grad_err_by_step=[f"{e:.3g}" for e in grad_errs],
          launches_by_rank=[r[1] for r in results],
          manual_spmd=[m[0]["manual_spmd"] for m, *_ in results])
    check(metric_err <= PARALLEL["gloo_rel"] and stable_err <= PARALLEL["gloo_abs"],
          f"two gloo ranks differ from one: metrics {metric_err:.3g}, params {stable_err:.3g}")
    check(grad_errs[0] <= PARALLEL["gloo_abs"],
          f"two gloo ranks' summed gradients differ from one rank's: {grad_errs}")
    check(all(r[1] == expected for r in results), f"rank launches {[r[1] for r in results]}, "
                                                    f"expected {expected} each")
    return counts


def stable_param_err(params, ref_params, grads):
    """Max |diff| of ``params`` from ``ref_params`` where every step's
    one-device |g| >= 100 * Adam's eps (train_against_cpu), the count of
    components below, and the max |diff| over all."""
    stable_err, below = 0.0, 0
    for name, ref in ref_params.items():
        diff = (params[name] - ref.cpu()).abs()
        stable = torch.ones_like(diff, dtype=torch.bool)
        for g in grads:
            if name in g:
                stable &= g[name].abs() >= 100 * 1e-8
        below += int((~stable).sum())
        stable_err = max(stable_err, diff[stable].max().item() if stable.any() else 0.0)
    all_err = max((params[n] - v.cpu()).abs().max().item() for n, v in ref_params.items())
    return stable_err, below, all_err


def model_axis_against_one_device(ranks, one, grads, one_params, fit_dir, layers, heads):
    """The model axis's results against the card's one-device runs.

    The transformer: the same seeded weights, batch and dropout masks (drawn
    whole and sliced), so the first update's metrics agree within
    MODEL_AXIS_TF["first_metrics"]; its gradients (the sharded ones gathered
    whole) within MODEL_AXIS_TF["first_grads"] (global relative L2; the
    model's own float32 noise: its LayerNorms' E[x^2] - E[x]^2 and ReLUs
    within rounding of zero put float32 gradients up to 1e-2 from float64 on
    a tensor, see transformer_train_against_cpu, and a sharded step sums in
    another order); the later updates, where AdamW moves every component by
    up to about lr whatever its gradient's size and so turns that noise into
    moves of up to lr, within MODEL_AXIS_TF["later_metrics"] and parameters
    within MODEL_AXIS_TF["params_lr_per_step"] lr a step (a wrong slice or
    gather parts them by the weights' own size). The data-parallel two-rank
    check's parameter figure (1e-5 where |g| >= 100 eps) is printed beside.
    Each rank's launches (4 layers x 3 steps of each training-attention
    kernel, 3 p2cp) and attention geometry (G = 45 pairs x B x H, n_pairs
    45); its channel stacks and heads at C / 2 rows.

    The fit checkpoint loaded into a one-device model: the keys, shapes and
    dtypes of a one-device model's, and its valid metrics the ranks' (1e-4
    relative), and both ranks' fit launches alike, every thesis kernel among
    them. Returns both ranks' launches together."""
    cfg = MODEL_AXIS_TF
    rel_errs = [max(abs(r["metrics"][i][k] - one[i][k]) / max(abs(one[i][k]), 1e-30)
                    for r in ranks for k in ("loss", "p2cp_mm")) for i in range(len(one))]
    got = ranks[0]["first_grads"]
    grad_err = (sum(((got[n] - g) ** 2).sum().item() for n, g in grads[0].items())
                / sum((g ** 2).sum().item() for g in grads[0].values())) ** 0.5
    stable_err, below, all_err = stable_param_err(ranks[0]["params"], one_params, grads)
    steps = cfg["steps"]
    expected = {"train_attention_fwd": layers * steps, "train_attention_bwd": layers * steps,
                "p2cp": steps}
    g = cfg["pairs"] * cfg["batch"] * heads
    geometry = {(g, cfg["t"], HD, cfg["pairs"])}
    calls = [set(r["calls"]) for r in ranks]
    phase("parallel", case="model_axis_transformer_1x2_gloo_cuda0", steps=steps,
          shape=f"B={cfg['batch']},T={cfg['t']},C=10,E=64,H={heads},layers={layers},"
                f"dropout={TRAIN['dropout']}",
          coords=[r["coords"] for r in ranks], rank_stack_rows=[r["stack_rows"] for r in ranks],
          sliced_tensors=[r["sliced"] for r in ranks],
          rel_err_metrics_by_step=[f"{e:.3g}" for e in rel_errs],
          first_grads_global_rel_l2=f"{grad_err:.3g}",
          max_abs_err_params_over_lr=f"{all_err / TRAIN['lr']:.3g}",
          data_parallel_rule_max_abs_err_params=f"{stable_err:.3g}", components_g_below_100eps=below,
          launches_by_rank=[r["counts"] for r in ranks], expected=expected,
          attend_calls_by_rank=[sorted(c) for c in calls],
          rank_seconds_3_steps=[f"{r['seconds']:.3f}" for r in ranks],
          **train_attention_geometry_text(g, cfg["t"], HD, cfg["pairs"]))
    check(rel_errs[0] <= cfg["first_metrics"] and grad_err <= cfg["first_grads"],
          f"the model axis's first update differs from one device: metrics {rel_errs[0]:.3g}, "
          f"gradients {grad_err:.3g}")
    check(max(rel_errs) <= cfg["later_metrics"]
          and all_err <= cfg["params_lr_per_step"] * steps * TRAIN["lr"],
          f"the model axis's updates differ from one device: metrics {rel_errs}, "
          f"params {all_err:.3g}")
    check(all(r["counts"] == expected for r in ranks),
          f"model-axis launches {[r['counts'] for r in ranks]}, expected {expected} each")
    check(all(c == geometry for c in calls), f"model-axis attention calls {calls}, "
                                             f"expected {geometry}")
    check(all(set(r["stack_rows"].values()) == {5} for r in ranks), "stacks not split")

    one_device = thesis_state(None)
    best = load_params(os.path.join(fit_dir, "best_model"))
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in one_device.model.state_dict().items()}
    same_layout = shapes == {k: (tuple(v.shape), v.dtype) for k, v in best.items()}
    restored, _ = restore_checkpoint(os.path.join(fit_dir, "last"), one_device)
    restored.model.load_state_dict(best)
    valid_loader = BucketedLoader(Corpus(TRAIN["n_valid"], seed=2), TRAIN["batch"], shuffle=False)
    ev = loop.run_eval_epoch(restored, valid_loader, make_artspeech_eval_step(TO_MM), "cuda")
    record = ranks[0]["fit"]["history"][0]
    fit_err = max(abs(ev[k] - record[f"valid_{k}"]) / abs(record[f"valid_{k}"])
                  for k in ("loss", "p2cp_mm"))
    fit_counts = [{k: v for k, v in r["fit"]["counts"].items() if v} for r in ranks]
    phase("parallel", case="model_axis_fit_thesis_1x2", epochs=len(ranks[0]["fit"]["history"]),
          head_rows_by_rank=[r["fit"]["head_rows"] for r in ranks], launches_by_rank=fit_counts,
          checkpoint_layout_one_device=same_layout, restored_step=restored.step,
          valid_loss_ranks=f"{record['valid_loss']:.6g}", valid_loss_one_device=f"{ev['loss']:.6g}",
          max_rel_err_valid_metrics=f"{fit_err:.3g}")
    check(same_layout, "the model-axis fit's best_model is not a one-device state dict")
    check(all(r["fit"]["head_rows"] == 5 for r in ranks), "fit did not split the heads")
    check(fit_counts[0] == fit_counts[1] and all(fit_counts[0].get(k) for k in PARALLEL_KERNELS),
          f"the model-axis fit's launches by rank: {fit_counts}")
    check(fit_err <= PARALLEL["gloo_rel"], f"the gathered checkpoint's valid metrics {ev} differ "
                                          f"from the ranks' {record}")
    return {k: sum(r["counts"].get(k, 0) + r["fit"]["counts"][k] for r in ranks) for k in KERNELS}


def reference_artspeech_state_dict(rng, n_art, vocab, embed, hidden, n_samples=50):
    """A seeded state dict in the reference ArtSpeech's key layout
    (encoder_decoder/models.py:99-145), numpy arrays."""
    def w(*shape):
        fan_in = shape[-1] if len(shape) > 1 else 1
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    sd = {"embedding.weight": w(vocab, embed) * np.sqrt(embed)}
    for layer, width in enumerate((embed, 2 * hidden)):
        for direction in ("", "_reverse"):
            sd[f"rnn.weight_ih_l{layer}{direction}"] = w(3 * hidden, width)
            sd[f"rnn.weight_hh_l{layer}{direction}"] = w(3 * hidden, hidden)
            sd[f"rnn.bias_ih_l{layer}{direction}"] = 0.1 * w(3 * hidden)
            sd[f"rnn.bias_hh_l{layer}{direction}"] = 0.1 * w(3 * hidden)
    sd["linear.0.weight"], sd["linear.0.bias"] = w(hidden, 2 * hidden), 0.1 * w(hidden)
    for i in range(n_art):
        for k, width in ((0, hidden), (3, 256), (6, 256)):
            sd[f"predictors.{i}.linear.{k}.weight"] = 1.0 + 0.1 * w(width)
            sd[f"predictors.{i}.linear.{k}.bias"] = 0.1 * w(width)
        for name, (fan_in, fan_out) in (("linear.1", (hidden, 256)), ("linear.4", (256, 256)),
                                        ("x_coords", (256, n_samples)),
                                        ("y_coords", (256, n_samples))):
            sd[f"predictors.{i}.{name}.weight"] = w(fan_out, fan_in)
            sd[f"predictors.{i}.{name}.bias"] = 0.1 * w(fan_out)
    return sd


def reference_import_path():
    """``convert_artspeech_state_dict`` at the thesis widths (10 articulators,
    embed 64, hidden 128): the imported model's forward on the card (its
    gru_fwd launches) against the CPU's within REFERENCE_IMPORT["tol"].
    Returns the card forward's launches."""
    sd = reference_artspeech_state_dict(np.random.default_rng(17), len(RECOGNITION_ARTICULATORS),
                                        VOCAB, 64, HIDDEN)
    imported = convert_artspeech_state_dict(sd)
    batch = fixed_batch(REFERENCE_IMPORT["b"], REFERENCE_IMPORT["t"], seed=19, device="cpu")
    out = {}
    for device in ("cpu", "cuda"):
        model = ArtSpeech(VOCAB, len(RECOGNITION_ARTICULATORS), device=device)
        model.load_state_dict(imported)
        torch.cuda.synchronize()
        reset_launch_counts()
        with torch.no_grad():
            out[device] = model(batch["tokens"].to(device), batch["lengths"].to(device)).cpu()
        torch.cuda.synchronize()
        counts = launch_counts()
    err = (out["cuda"] - out["cpu"]).abs().max().item()
    phase("parallel", case="reference_artspeech_import",
          shape=f"B={REFERENCE_IMPORT['b']},T={REFERENCE_IMPORT['t']},arts=10,embed=64,"
                f"hidden={HIDDEN}", keys=len(sd), max_abs_err_card_vs_cpu=f"{err:.3g}",
          tol=REFERENCE_IMPORT["tol"], gru_fwd_launches=counts["gru_fwd"],
          finite=bool(torch.isfinite(out["cuda"]).all()))
    check(err <= REFERENCE_IMPORT["tol"] and torch.isfinite(out["cuda"]).all(),
          f"imported ArtSpeech: card vs CPU {err:.3g}")
    check(counts["gru_fwd"] == 2, f"imported ArtSpeech: {counts['gru_fwd']} gru_fwd launches")
    return counts


def parallel_path():
    """The [parallel] phase; returns the launches of its paths: the one-rank
    group step's, the model axis's (both ranks) and the reference import's."""
    t0 = time.perf_counter()
    host = parallel_batch()
    counts = {"parallel": parallel_one_rank(host)}
    counts["parallel_model_axis"] = parallel_two_gloo_ranks(host)
    counts["reference_import"] = reference_import_path()
    t1 = time.perf_counter()
    losses = dryrun_multichip(2, backend="gloo")
    phase("parallel", case="dryrun_multichip_2_gloo", seconds=f"{time.perf_counter() - t1:.3f}",
          **{k: f"{v:.6g}" for k, v in losses.items()})
    phase("parallel", seconds=f"{time.perf_counter() - t0:.3f}")
    return counts


# -- the thesis workflow through the CLIs --------------------------------------

CLI_PATHS = ("cli_train", "cli_test", "cli_generate", "cli_generate_vcv", "cli_train_transformer",
             "cli_transformer", "cli_train_bf16", "cli_train_transformer_bf16", "cli_train_fp16",
             "cli_train_transformer_fp16")
#: The 16-bit CLI runs and their compute dtypes: the bf16 configs as they
#: are, and again with compute_dtype: float16 (the transformer's test also
#: with generate_cache_dtype: float16).
HALF_CLI_RUNS = {"cli_train_bf16": torch.bfloat16, "cli_train_transformer_bf16": torch.bfloat16,
                 "cli_train_fp16": torch.float16, "cli_train_transformer_fp16": torch.float16}


def launch_counts():
    return {"gru_fwd": hopper_gru.launches, "gru_bwd": hopper_gru.bwd_launches,
            "p2cp": hopper_p2cp.launches, "min_dist": hopper_min_dist.launches,
            "flash_decode": hopper_attention.launches,
            "train_attention_fwd": hopper_train_attention.launches_fwd,
            "train_attention_bwd": hopper_train_attention.launches_bwd,
            "lstm_fwd": hopper_lstm.launches, "lstm_bwd": hopper_lstm.bwd_launches,
            "gru_seq": hopper_gru.launches_seq}


def reset_launch_counts():
    hopper_gru.launches = hopper_gru.bwd_launches = hopper_p2cp.launches = 0
    hopper_min_dist.launches = hopper_attention.launches = 0
    hopper_train_attention.launches_fwd = hopper_train_attention.launches_bwd = 0
    hopper_lstm.launches = hopper_lstm.bwd_launches = hopper_gru.launches_seq = 0


def batch_buckets(lengths, batch_size):
    """The bucket length of each batch BucketedLoader makes of sentences of
    these lengths."""
    per_bucket = {}
    for length in lengths:
        bucket = pick_bucket(length, DEFAULT_BUCKETS)
        per_bucket[bucket] = per_bucket.get(bucket, 0) + 1
    return [bucket for bucket, n in sorted(per_bucket.items()) for _ in range(-(-n // batch_size))]


def n_batches(lengths, batch_size):
    return len(batch_buckets(lengths, batch_size))


def thesis_config(name, path, changes, added=None, folder=THESIS_CONFIGS):
    """Write ``folder``/<name>.yaml to ``path`` with the value of each
    top-level key in ``changes`` replaced, line by line, and the keys of
    ``added`` appended (a mapping as a block); a key ``parent.child`` of ``changes`` replaces, or
    adds, the child's line in the block of the top-level mapping ``parent``.
    Returns the config as the CLI reads it, after checking that no other key
    differs from the repository's."""
    added = added or {}
    src = os.path.join(folder, f"{name}.yaml")
    with open(src) as f:
        lines = f.read().splitlines()
    nested = {tuple(k.split(".", 1)): v for k, v in changes.items() if "." in k}
    out = []
    for line in lines:
        key = line.split(":", 1)[0]
        out.append(f"{key}: {changes[key]}" if key in changes else line)
    for (parent, child), value in nested.items():
        at = out.index(f"{parent}:") + 1
        block = at
        while block < len(out) and out[block].startswith("  "):
            block += 1
        entry = f"  {child}: {value}"
        mine = [i for i in range(at, block) if out[i].strip().split(":", 1)[0] == child]
        if mine:
            out[mine[0]] = entry
        else:
            out.insert(at, entry)
    for key, value in added.items():
        out += yaml_lines(key, value)
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
    cfg, original = config_file.load(path), config_file.load(src)
    changed = {k for k in cfg.keys() | original.keys() if cfg.get(k) != original.get(k)}
    for parent in {p for p, _ in nested}:
        children = {c for p, c in nested if p == parent}
        strip = lambda d: {k: v for k, v in (d or {}).items() if k not in children}  # noqa: E731
        check(strip(cfg[parent]) == strip(original[parent]),
              f"{name}: {parent} changed beyond {sorted(children)}")
        changed.discard(parent)
    check(changed <= set(changes) | set(added) and set(cfg) == set(original) | set(added),
          f"{name}: keys {sorted(changed)} changed, only {sorted(changes)} and {sorted(added)} may")
    return cfg


def yaml_lines(key, value, indent=""):
    """``key: value`` as block YAML lines; a mapping value becomes a block."""
    if not isinstance(value, dict):
        return [f"{indent}{key}: {value}"]
    lines = [f"{indent}{key}:"]
    for k, v in value.items():
        lines += yaml_lines(k, v, indent + "  ")
    return lines


def run_cli(module, config_path, output_dir, device=None):
    """One CLI in-process through its run_experiment, as ``python -m`` runs
    it (no --device: the card, unless ``device`` is given). Returns (result,
    wall seconds)."""
    saved = sys.argv
    sys.argv = [module.__name__, "--config", config_path, "--output_dir", output_dir,
                "--run_name", "run"] + (["--device", device] if device else [])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = run_experiment(module.__name__, module.main)
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0
    finally:
        sys.argv = saved


def finite_npys(directory):
    names = os.listdir(directory)
    for name in names:
        check(np.isfinite(np.load(os.path.join(directory, name))).all(),
              f"non-finite values in {directory}/{name}")
    return len(names)


def read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def check_test_outputs(outputs_dir, lengths, n_arts):
    """Per test sentence: the contours (predicted and true) of every frame
    and articulator, one phonemes.csv and one tract_variables.csv row per
    frame, all finite. Returns the frames and TV rows seen."""
    check(sorted(os.listdir(outputs_dir)) == sorted(lengths), f"sentences in {outputs_dir}")
    tv_rows = 0
    for name, length in lengths.items():
        sentence = os.path.join(outputs_dir, name)
        n = finite_npys(os.path.join(sentence, "contours"))
        check(n == 2 * n_arts * length, f"{n} contour files for {length} frames in {sentence}")
        check(len(read_csv(os.path.join(sentence, "phonemes.csv"))[1]) == length,
              f"phonemes.csv rows in {sentence}")
        head, rows = read_csv(os.path.join(sentence, "tract_variables.csv"))
        check(len(rows) == length, f"{len(rows)} TV rows for {length} frames in {sentence}")
        values = np.array([[float(x) for x in row[3:]] for row in rows])
        check(head[3:] and np.isfinite(values).all(), f"non-finite TVs in {sentence}")
        tv_rows += len(rows)
    return sum(lengths.values()), tv_rows


def check_synthesis(save_to, sentences, n_arts):
    """Per sentence: inference_contours of every frame and articulator,
    air_column and xarticul of every frame, all finite."""
    for item in sentences:
        sentence = os.path.join(save_to, item["subject"], item["sentence_name"])
        length = len(item["phonemes"])
        check(finite_npys(os.path.join(sentence, "inference_contours")) == length * n_arts,
              f"inference_contours in {sentence}")
        check(finite_npys(os.path.join(sentence, "air_column")) == length,
              f"air_column in {sentence}")
        xarticul = os.listdir(os.path.join(sentence, "xarticul"))
        check(len(xarticul) == length and all(
            np.isfinite(np.loadtxt(os.path.join(sentence, "xarticul", x))).all()
            for x in xarticul), f"xarticul in {sentence}")
    return sum(len(item["phonemes"]) for item in sentences)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def cli_path(tmp):
    """The thesis workflow through the three CLIs on the card. Returns the
    launch counts of each CLI run, their wall seconds and what the card-vs-CPU
    test-step check needs."""
    corpus, vcv = os.path.join(tmp, "corpus"), os.path.join(tmp, "vcv")
    t0 = time.perf_counter()
    info = make_synthetic_corpus(corpus, subjects=(CLI_CORPUS["subject"],),
                                 sequences=CLI_CORPUS["sequences"],
                                 n_sentences=CLI_CORPUS["n_sentences"],
                                 frames_per_sentence=CLI_CORPUS["frames_per_sentence"],
                                 framerate=DATASET_CONFIG["gottingen"].FRAMERATE)
    vocab_path = os.path.join(corpus, "vocabulary.json")
    with open(vocab_path, "w") as f:
        json.dump(info["phonemes"], f)
    make_vcv_corpus(vcv)
    n_files = sum(len(names) for _, _, names in os.walk(corpus))
    phase("cli", corpus_files=n_files, vcv_textgrids=sum(len(n) for _, _, n in os.walk(vcv)),
          seconds=f"{time.perf_counter() - t0:.3f}")

    out = os.path.join(tmp, "train_run")
    best_state = os.path.join(out, "checkpoints", "best", "state")
    corpus_keys = {"database_name": "gottingen", "datadir": corpus, "vocab_filepath": vocab_path}
    configs = {
        "cli_train": ("train_model_free", {**corpus_keys, "num_epochs": 2}),
        "cli_test": ("test_model_free", {**corpus_keys, "state_dict_filepath": best_state}),
        "cli_generate": ("generate_vocal_tract_shape_model_free",
                         {**corpus_keys, "state_dict_filepath": best_state,
                          "save_to": os.path.join(tmp, "synthesis")}),
        "cli_generate_vcv": ("generate_vcv_model_free",
                             {"datadir": vcv, "vocab_filepath": vocab_path,
                              "state_dict_filepath": os.path.join(out, "checkpoints", "best_model"),
                              "save_to": os.path.join(tmp, "vcv_synthesis")}),
        "cli_train_transformer": ("train_transformer", {**corpus_keys, "num_epochs": 2}),
        "cli_transformer": ("train_transformer", corpus_keys),
        "cli_train_bf16": ("train_model_free_bf16", {**corpus_keys, "num_epochs": 2}),
        "cli_train_transformer_bf16": ("train_transformer_bf16",
                                       {**corpus_keys, "num_epochs": 2}),
        "cli_train_fp16": ("train_model_free_bf16",
                           {**corpus_keys, "num_epochs": 2, "compute_dtype": "float16"}),
        "cli_train_transformer_fp16": ("train_transformer_bf16",
                                       {**corpus_keys, "num_epochs": 2,
                                        "compute_dtype": "float16"}),
    }
    tf_out = os.path.join(tmp, "train_transformer_run")
    added = {"cli_transformer": {
        "state_dict_filepath": os.path.join(tf_out, "checkpoints", "best", "state"),
        "save_to": os.path.join(tmp, "transformer_outputs")},
        "cli_train_transformer_fp16": {"generate_cache_dtype": "float16"}}
    cfgs = {p: thesis_config(name, os.path.join(tmp, f"{p}.yaml"), changes, added.get(p))
            for p, (name, changes) in configs.items()}

    train_cfg = cfgs["cli_train"]
    arts, batch, epochs = sorted(train_cfg["articulators"]), train_cfg["batch_size"], 2
    vocabulary = load_vocabulary(vocab_path)

    def lengths(key, cfg=train_cfg):
        dataset = ArtSpeechDataset(corpus, "gottingen", sequences_from_dict(corpus, cfg[key]),
                                   vocabulary, sorted(cfg["articulators"]),
                                   clip_tails=cfg["clip_tails"])
        return {d["sentence_name"]: len(d["frame_ids"]) for d in dataset.data}

    def synthesis_sentences(p):
        cfg = cfgs[p]
        return DATABASE_COLLECTORS[cfg["database_name"]](cfg["datadir"]).collect_data(
            sequences_from_dict(cfg["datadir"], cfg["seq_dict"]))

    test_lengths = lengths("test_seq_dict")
    tr, va, te = (n_batches(lengths("train_seq_dict").values(), batch),
                  n_batches(lengths("valid_seq_dict").values(), batch),
                  n_batches(test_lengths.values(), batch))
    sentences = {p: synthesis_sentences(p) for p in ("cli_generate", "cli_generate_vcv")}
    # The transformer trains with one forward and one backward
    # train_attention launch a decoder layer and step, validates with one
    # P2CP launch a batch, and tests autoregressively: each test batch is
    # decoded over its bucket length T with bf16 caches, 4 layers x (self,
    # cross-channel) flash_decode launches a step. The train CLI tests at
    # batch_size, the test CLI at max(batch_size, 64) on the card.
    tf_cfg = cfgs["cli_transformer"]
    tf_layers, tf_batch = tf_cfg["model_kwargs"]["num_layers"], tf_cfg["batch_size"]
    tf_test_lengths = lengths("test_seq_dict", tf_cfg).values()
    tf_buckets = batch_buckets(tf_test_lengths, max(tf_batch, 64))
    tf_train_buckets = batch_buckets(tf_test_lengths, tf_batch)
    tf_tr = n_batches(lengths("train_seq_dict", tf_cfg).values(), tf_batch)
    tf_va = n_batches(lengths("valid_seq_dict", tf_cfg).values(), tf_batch)
    none = dict.fromkeys(KERNELS, 0)
    # Two BiGRU layers: one forward (and in training one backward) launch
    # each; one P2CP launch per eval step and per test batch (the
    # per-sentence metrics); one min_dist launch for the 4 TVs of the
    # predictions and one for the targets' per test batch.
    expected = {
        "cli_train": {**none, "gru_fwd": 2 * (epochs * (tr + va) + te), "gru_bwd": 2 * epochs * tr,
                      "p2cp": epochs * va + te, "min_dist": 2 * te},
        "cli_test": {**none, "gru_fwd": 2 * te, "p2cp": te, "min_dist": 2 * te},
        **{p: {**none, "gru_fwd": 2 * -(-len(s) // 8)} for p, s in sentences.items()},
        "cli_train_transformer": {
            **none, "train_attention_fwd": tf_layers * epochs * tf_tr,
            "train_attention_bwd": tf_layers * epochs * tf_tr,
            "p2cp": epochs * tf_va + len(tf_train_buckets), "min_dist": 2 * len(tf_train_buckets),
            "flash_decode": sum(2 * tf_layers * t for t in tf_train_buckets)},
        "cli_transformer": {**none, "p2cp": len(tf_buckets), "min_dist": 2 * len(tf_buckets),
                            "flash_decode": sum(2 * tf_layers * t for t in tf_buckets)},
    }
    # The 16-bit configs are the f32 ones with compute_dtype: bfloat16 or
    # float16, so the same launches (the GRU kernels and the decode's caches
    # in the 16-bit type; the training attention in f32 around its kernel,
    # as JAX).
    for p in HALF_CLI_RUNS:
        expected[p] = expected["cli_train_transformer" if "transformer" in p else "cli_train"]
    phase("cli", train_batches_per_epoch=tr, valid_batches=va, test_batches=te,
          transformer_train_batches_per_epoch=tf_tr, transformer_valid_batches=tf_va,
          transformer_test_buckets=tf_buckets, test_frames=sum(test_lengths.values()),
          **{f"{p}_sentences": len(s) for p, s in sentences.items()})

    modules = {"cli_train": train_phoneme_to_articulation, "cli_test": test_phoneme_to_articulation,
               "cli_generate": generate_vocal_tract_shape,
               "cli_generate_vcv": generate_vocal_tract_shape,
               "cli_train_transformer": train_phoneme_to_articulation_transformer,
               "cli_transformer": test_phoneme_to_articulation_transformer,
               **{p: train_phoneme_to_articulation_transformer if "transformer" in p
                  else train_phoneme_to_articulation for p in HALF_CLI_RUNS}}
    outputs = {"cli_train": out, "cli_test": os.path.join(tmp, "test_run"),
               "cli_generate": os.path.join(tmp, "generate_run"),
               "cli_generate_vcv": os.path.join(tmp, "generate_vcv_run"),
               "cli_train_transformer": tf_out,
               "cli_transformer": os.path.join(tmp, "transformer_run"),
               **{p: os.path.join(tmp, f"{p[4:]}_run") for p in HALF_CLI_RUNS}}
    results, launches, seconds = {}, {}, {}
    for p in CLI_PATHS:
        reset_launch_counts()
        results[p], seconds[p] = run_cli(modules[p], os.path.join(tmp, f"{p}.yaml"), outputs[p])
        launches[p] = launch_counts()
        phase("cli", cli=p, seconds=f"{seconds[p]:.3f}",
              **{f"{k}_launches": v for k, v in launches[p].items()},
              **{f"{k}_expected": v for k, v in expected[p].items()})
        check(launches[p] == expected[p], f"{p}: kernel launches {launches[p]}, "
                                          f"expected {expected[p]}")
    check(launches["cli_train"]["min_dist"] > 0 and launches["cli_test"]["min_dist"] > 0,
          "the test paths launched no min_dist kernel")
    check(launches["cli_transformer"]["flash_decode"] > 0,
          "the transformer test CLI launched no flash_decode kernel")
    check(launches["cli_train_transformer"]["train_attention_bwd"] > 0,
          "the transformer train CLI launched no train_attention kernel")

    # What the CLIs wrote.
    for run in (out, tf_out, *(outputs[p] for p in HALF_CLI_RUNS)):
        for sub in ("checkpoints/best/state.pt", "checkpoints/best/aux.json",
                    "checkpoints/last/state.pt", "checkpoints/last/aux.json",
                    "checkpoints/best_model", "test_results.json", "run/params.json",
                    "run/metrics.jsonl"):
            check(os.path.isfile(os.path.join(run, sub)), f"the train CLI wrote no {run}/{sub}")
        with open(os.path.join(run, "run", "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        check([r["epoch"] for r in records] == list(range(epochs)), f"{run}: metrics.jsonl epochs")
        check(all(np.isfinite(v) for r in records for k, v in r.items() if k != "ts"),
              f"{run}: non-finite epoch metrics")
        phase("cli", run=os.path.basename(run), **fmt({k: v for k, v in records[-1].items()
                                                       if k != "ts"}))
    n_arts = len(arts) + 1  # with the upper incisor
    test_dirs = {p: os.path.join(outputs[p], "test_outputs", "0")
                 for p in ("cli_train", "cli_test", "cli_train_transformer", *HALF_CLI_RUNS)}
    test_dirs["cli_transformer"] = cfgs["cli_transformer"]["save_to"]
    for p, test_dir in test_dirs.items():
        frames, tv_rows = check_test_outputs(test_dir, test_lengths, n_arts)
        with open(os.path.join(outputs[p], "test_results.json")) as f:
            written = flat(json.load(f))
        check(written == flat(results[p]) and all(np.isfinite(v) for v in written.values()),
              f"{p}: test_results.json")
        phase("cli", cli=p, test_frames=frames, tv_csv_rows=tv_rows, finite=True,
              loss=f"{results[p]['loss']:.6g}",
              mean_p2cp_mm=f"{np.mean([results[p][a]['p2cp_mm'] for a in arts]):.6g}")
    train_info, test_info = flat(results["cli_train"]), flat(results["cli_test"])
    diff = max(abs(test_info[k] - v) for k, v in train_info.items())
    phase("cli", test_cli_vs_train_cli_final_test_max_abs_diff=f"{diff:.3g}", tol=1e-6)
    check(test_info.keys() == train_info.keys() and diff <= 1e-6,
          f"the test CLI's results differ from the train CLI's final test by {diff}")
    for p, s in sentences.items():
        frames = check_synthesis(cfgs[p]["save_to"], s, n_arts)
        check(len(results[p]) == len(s), f"{p}: {len(results[p])} sentences written")
        phase("cli", cli=p, sentences=len(s), frames=frames, finite=True)
    t0 = time.perf_counter()
    half_against_cpu(outputs, cfgs, corpus, vocab_path)
    phase("cli", half_against_cpu_seconds=f"{time.perf_counter() - t0:.3f}")
    return launches, seconds, (best_state, corpus, vocab_path, train_cfg)


def half_against_cpu(outputs, cfgs, corpus, vocab_path):
    """The 16-bit models the bf16 and fp16 train CLIs left (best/state), on
    one test batch: the forward on the card in the run's dtype against the
    same forward on the CPU in that dtype (the plain versions), within
    BF16_FORWARD_TOL of max |ref| or, where larger, twice the distance of
    the CPU's 16-bit output from its float32 output on the same weights (the
    bound tests/test_torch_port_bf16.py holds the port to against flax). The
    fp16 runs compare the batch's first sentence only: the card host's CPU
    computes fp16 slowly (the transformer's forward at B = 4, T = 128 took
    18.5 s, 1.3 s in bf16), and the whole batch took the script past its
    time."""
    vocabulary = load_vocabulary(vocab_path)
    for p, half in HALF_CLI_RUNS.items():
        cfg = cfgs[p]
        arts = sorted(cfg["articulators"])
        dataset = ArtSpeechDataset(corpus, "gottingen",
                                   sequences_from_dict(corpus, cfg["test_seq_dict"]), vocabulary,
                                   arts, clip_tails=cfg["clip_tails"])
        batch, _ = next(iter(BucketedLoader(dataset, cfg["batch_size"], shuffle=False)))
        if half == torch.float16:
            batch = {k: v[:1] for k, v in batch.items()}
        params = load_params(os.path.join(outputs[p], "checkpoints", "best", "state"))
        kwargs = model_kwargs_from_cfg(cfg)
        check(kwargs.get("dtype") == half, f"{p}: the config's dtype is {kwargs}")
        outs = {}
        for device, dtype in (("cuda", half), ("cpu", half), ("cpu", torch.float32)):
            kw = {**kwargs, "dtype": None if dtype == torch.float32 else dtype}
            tokens, lengths = (torch.as_tensor(batch[k], device=device)
                               for k in ("tokens", "lengths"))
            if "transformer" not in p:
                model = ArtSpeech(len(vocabulary), len(arts), **kw, device=device)
                model.load_state_dict(params)
                args = (tokens, lengths)
            else:
                model = ArtSpeechTransformer(len(vocabulary), len(arts),
                                             num_feat=2 * cfg.get("n_samples", 50), **kw,
                                             device=device)
                model.load_state_dict(params)
                targets = torch.as_tensor(batch["targets"], device=device)
                args = (tokens, shift_targets_right(targets), lengths, lengths)
            with torch.inference_mode():
                outs[(device, dtype)] = model(*args).float().cpu()
        got, ref, f32 = outs[("cuda", half)], outs[("cpu", half)], outs[("cpu", torch.float32)]
        valid = torch.arange(got.shape[1])[None, :] < torch.as_tensor(batch["lengths"])[:, None]
        tol = max(BF16_FORWARD_TOL * ref.abs().max().item(),
                  2 * (ref - f32).abs()[valid].max().item())
        err = (got - ref).abs()[valid].max().item()
        phase("cli", half_forward=p, dtype=str(half).split(".")[-1],
              card_vs_cpu_max_abs_err=f"{err:.3g}", tol=f"{tol:.3g}",
              cpu_half_vs_f32=f"{(ref - f32).abs()[valid].max().item():.3g}")
        check(torch.isfinite(got).all().item() and err <= tol,
              f"{p}: the card's {half} forward differs from the CPU's by {err} (tol {tol})")


def test_step_against_cpu(best_state, corpus, vocab_path, cfg):
    """One test batch (the first of S05: 12 rows at bucket 128) through the
    test step on the card and on the CPU, same weights: loss, metrics and TV
    values within TEST_STEP_TOL on the valid frames; the same places of
    constriction (within TEST_STEP_TOL, i.e. the same contour points) on at
    least TV_SAME_PAIR_SHARE of them."""
    vocabulary = load_vocabulary(vocab_path)
    arts = sorted(cfg["articulators"])
    dataset = ArtSpeechDataset(corpus, "gottingen", sequences_from_dict(corpus, cfg["test_seq_dict"]),
                               vocabulary, arts, clip_tails=cfg["clip_tails"])
    batch, _ = next(iter(BucketedLoader(dataset, cfg["batch_size"], shuffle=False)))
    params = load_params(best_state)
    out = {}
    for device in ("cuda", "cpu"):
        model = ArtSpeech(len(vocabulary), len(arts), device=device)
        model.load_state_dict(params)
        step, _ = make_test_step(model, arts, device=device)
        out[device] = {k: v.cpu().numpy() for k, v in flat(step(batch)).items()}
    valid = np.arange(batch["tokens"].shape[1])[None, :] < batch["lengths"][:, None]
    errs, shares = {}, {}
    for key, ref in out["cpu"].items():
        got = out["cuda"][key]
        if "/poc_" in key:
            continue
        if key.startswith("tvs_"):
            got, ref = got[valid], ref[valid]
        errs[key] = float(np.abs(got - ref).max())
    for key in (k for k in out["cpu"] if k.endswith("/poc_1")):
        same = np.ones(valid.sum(), bool)
        for poc in (key, key[:-1] + "2"):
            same &= (np.abs(out["cuda"][poc] - out["cpu"][poc])[valid] <= TEST_STEP_TOL).all(-1)
        shares[key[:-len("/poc_1")]] = float(same.mean())
    worst = max(v for k, v in errs.items() if k not in ("outputs", "targets"))
    phase("cli", test_step_card_vs_cpu_tol=TEST_STEP_TOL, rows=int(valid.sum()),
          max_abs_err_metrics_and_tvs=f"{worst:.3g}", max_abs_err_outputs=f"{errs['outputs']:.3g}",
          **{f"same_pair_share_{k.replace('/', '_')}": f"{v:.4f}" for k, v in shares.items()})
    check(max(errs.values()) <= TEST_STEP_TOL, f"card and CPU test steps disagree: {errs}")
    check(min(shares.values()) >= TV_SAME_PAIR_SHARE,
          f"card and CPU pick other places of constriction: {shares}")


# -- the autoencoder-based method through its CLIs -------------------------------

MC_CONFIGS = os.path.join(REPO, "configs", "mean_contour")
MC_PATHS = ("mc_train", "mc_test", "mc_generate")


def mean_contour_path(tmp, corpus, vocab_path):
    """The mean-contour baseline (method A) through its three CLIs on the
    card, from YAML files written from the text of configs/mean_contour/
    (only the corpus paths, the database, table_filepath / state_dict_filepath
    and save_to changed) over the [cli] corpus: the train CLI (the table,
    then its test with tract variables), the test CLI on that table and the
    generate CLI with method: mean_contour. The table lookup is plain torch;
    the test step launches one P2CP a batch and 2 min_dist (the 4 TVs of
    the predictions in one, the targets' in the other), which are counted,
    and the synthesis none. Checks
    the table, the artifact trees, finiteness, and the test CLI's results
    against the train CLI's final test. Returns the launches and wall
    seconds of each run."""
    corpus_keys = {"database_name": "gottingen", "datadir": corpus, "vocab_filepath": vocab_path}
    out = {p: os.path.join(tmp, p) for p in MC_PATHS}
    table_path = os.path.join(out["mc_train"], "mean_contour_table.npz")
    configs = {
        "mc_train": ("train_mean_contour", corpus_keys, None),
        "mc_test": ("test_mean_contour", {**corpus_keys, "table_filepath": table_path}, None),
        "mc_generate": ("generate_vocal_tract_shape_mean_contour",
                        {**corpus_keys, "state_dict_filepath": table_path,
                         "save_to": os.path.join(tmp, "mc_synthesis")}, None),
    }
    cfgs = {p: thesis_config(name, os.path.join(tmp, f"{p}.yaml"), changes, added,
                             folder=MC_CONFIGS)
            for p, (name, changes, added) in configs.items()}
    vocabulary = load_vocabulary(vocab_path)
    cfg = cfgs["mc_train"]
    arts = sorted(cfg["articulators"])
    test_lengths = {d["sentence_name"]: len(d["frame_ids"]) for d in ArtSpeechDataset(
        corpus, "gottingen", sequences_from_dict(corpus, cfg["test_seq_dict"]), vocabulary, arts,
        clip_tails=cfg["clip_tails"]).data}
    te = n_batches(test_lengths.values(), cfg["batch_size"])
    none = dict.fromkeys(KERNELS, 0)
    expected = {"mc_train": {**none, "p2cp": te, "min_dist": 2 * te},
                "mc_test": {**none, "p2cp": te, "min_dist": 2 * te}, "mc_generate": none}
    modules = {"mc_train": train_phoneme_wise_mean_contour,
               "mc_test": test_phoneme_wise_mean_contour, "mc_generate": generate_vocal_tract_shape}
    results, launches, seconds = {}, {}, {}
    for p in MC_PATHS:
        reset_launch_counts()
        results[p], seconds[p] = run_cli(modules[p], os.path.join(tmp, f"{p}.yaml"), out[p])
        launches[p] = launch_counts()
        phase("mean_contour", cli=p, seconds=f"{seconds[p]:.3f}",
              **{f"{k}_launches": v for k, v in launches[p].items() if v or expected[p][k]},
              **{f"{k}_expected": v for k, v in expected[p].items() if v})
        check(launches[p] == expected[p], f"{p}: kernel launches {launches[p]}, "
                                          f"expected {expected[p]}")
    table = np.load(table_path)
    check(table["table"].shape == (len(vocabulary), len(arts), 2, 50)
          and np.isfinite(table["table"]).all() and not bool(table["positional"]),
          f"mean_contour_table.npz: {table['table'].shape}")
    n_arts = len(arts) + 1  # with the upper incisor
    test_dirs = {"mc_train": os.path.join(out["mc_train"], "test_outputs", "0"),
                 "mc_test": os.path.join(out["mc_test"], "test_outputs", "0")}
    for p, test_dir in test_dirs.items():
        frames, tv_rows = check_test_outputs(test_dir, test_lengths, n_arts)
        with open(os.path.join(out[p], "test_results.json")) as f:
            written = flat(json.load(f))
        check(written == flat(results[p]) and all(np.isfinite(v) for v in written.values()),
              f"{p}: test_results.json")
        phase("mean_contour", cli=p, test_frames=frames, tv_csv_rows=tv_rows, finite=True,
              loss=f"{results[p]['loss']:.6g}",
              mean_p2cp_mm=f"{np.mean([results[p][a]['p2cp_mm'] for a in arts]):.6g}")
    train_info, test_info = flat(results["mc_train"]), flat(results["mc_test"])
    diff = max(abs(test_info[k] - v) for k, v in train_info.items())
    phase("mean_contour", test_cli_vs_train_cli_final_test_max_abs_diff=f"{diff:.3g}", tol=1e-6)
    check(test_info.keys() == train_info.keys() and diff <= 1e-6,
          f"the mean-contour test CLI differs from the train CLI's final test by {diff}")
    sentences = DATABASE_COLLECTORS["gottingen"](corpus).collect_data(
        sequences_from_dict(corpus, cfgs["mc_generate"]["seq_dict"]))
    frames = check_synthesis(cfgs["mc_generate"]["save_to"], sentences, n_arts)
    check(len(results["mc_generate"]) == len(sentences),
          f"mc_generate: {len(results['mc_generate'])} sentences written")
    phase("mean_contour", cli="mc_generate", sentences=len(sentences), frames=frames, finite=True)
    return launches, seconds


PC_PATHS = ("pc_norm_stats", "pc_train_pca", "pc_train_ae", "pc_test_ae", "pc_train_ae_gru",
            "pc_train_ae_lstm", "pc_train_pca_gru", "pc_test_lstm", "pc_generate")


def pc_path(tmp, corpus, vocab_path):
    """The autoencoder-based method through its nine CLI runs on the card,
    over the [cli] corpus, from YAML files written from the text of
    configs/autoencoder_based/ (only paths, the database, num_epochs: 2,
    state-dict paths and, for the LSTM model, model_kwargs.rnn /
    model_params.rnn changed). Returns the launch counts and wall seconds of
    each run."""
    corpus_keys = {"database_name": "gottingen", "datadir": corpus, "vocab_filepath": vocab_path}
    out = {p: os.path.join(tmp, p) for p in PC_PATHS}
    ae_ckpts = os.path.join(out["pc_train_ae"], "checkpoints")
    ae_paths = {"encoder_state_dict_filepath": os.path.join(ae_ckpts, "best_encoder"),
                "decoder_state_dict_filepath": os.path.join(ae_ckpts, "best_decoder")}
    pca = os.path.join(out["pc_train_pca"], "pca")
    lstm = os.path.join(out["pc_train_ae_lstm"], "checkpoints")
    configs = {
        "pc_norm_stats": ("norm_stats", corpus_keys),
        "pc_train_pca": ("train_articulatory_pca", corpus_keys),
        "pc_train_ae": ("train_autoencoder", {**corpus_keys, "num_epochs": 2}),
        "pc_test_ae": ("test_autoencoder", {"database_name": "gottingen", "datadir": corpus,
                                            "checkpoint_dir": os.path.join(ae_ckpts, "best")}),
        "pc_train_ae_gru": ("train_autoencoder_based", {**corpus_keys, "num_epochs": 2, **ae_paths}),
        "pc_train_ae_lstm": ("train_autoencoder_based", {**corpus_keys, "num_epochs": 2, **ae_paths,
                                                         "model_kwargs.rnn": "LSTM"}),
        "pc_train_pca_gru": ("train_pca_based", {
            **corpus_keys, "num_epochs": 2,
            "encoder_state_dict_filepath": os.path.join(pca, "encoder"),
            "decoder_state_dict_filepath": os.path.join(pca, "decoder")}),
        "pc_test_lstm": ("test_autoencoder_based", {
            **corpus_keys, **ae_paths, "state_dict_filepath": os.path.join(lstm, "best", "state"),
            "model_kwargs.rnn": "LSTM"}),
        "pc_generate": ("generate_vocal_tract_shape_autoencoder", {
            **corpus_keys, "state_dict_filepath": os.path.join(lstm, "best_model"),
            "decoder_state_dict_filepath": ae_paths["decoder_state_dict_filepath"],
            "norm_stats_dir": corpus, "save_to": os.path.join(tmp, "pc_synthesis"),
            "model_params.rnn": "LSTM"}),
    }
    cfgs = {p: thesis_config(name, os.path.join(tmp, f"{p}.yaml"), changes, folder=PC_CONFIGS)
            for p, (name, changes) in configs.items()}

    # Counted beforehand from the corpus: the autoencoder validates with one
    # P2CP launch a frame batch and tests with two (the eval step's metric
    # and the per-articulator errors); a latent-RNN forward is one launch of
    # its kernel a BiGRU/BiLSTM layer (2), a train step adds 2 backward
    # launches, a valid batch one P2CP launch, a test batch one P2CP and 2
    # min_dist launches (the 4 TVs of predictions, then of targets); the
    # synthesis, one forward a batch of 8 sentences.
    vocabulary = load_vocabulary(vocab_path)
    arts = sorted(normalize_indices_dict(cfgs["pc_train_ae"]["indices_dict"]))

    def frames(p, key):
        cfg = cfgs[p]
        n = len(AutoencoderDataset(corpus, "gottingen", sequences_from_dict(corpus, cfg[key]),
                                   arts, clip_tails=cfg.get("clip_tails", True)))
        return -(-n // cfg["batch_size"])

    def lengths(p, key):
        cfg = cfgs[p]
        dataset = PrincipalComponentsDataset(corpus, "gottingen",
                                             sequences_from_dict(corpus, cfg[key]), vocabulary,
                                             arts, clip_tails=cfg.get("clip_tails", True))
        return {d["sentence_name"]: len(d["frame_ids"]) for d in dataset.data}

    none, epochs = dict.fromkeys(KERNELS, 0), 2
    ae_va, ae_te = frames("pc_train_ae", "valid_seq_dict"), frames("pc_train_ae", "test_seq_dict")
    expected = {"pc_norm_stats": none, "pc_train_pca": none,
                "pc_train_ae": {**none, "p2cp": epochs * ae_va + 2 * ae_te},
                "pc_test_ae": {**none, "p2cp": 2 * frames("pc_test_ae", "test_seq_dict")}}
    for p, fwd, bwd in (("pc_train_ae_gru", "gru_fwd", "gru_bwd"),
                        ("pc_train_ae_lstm", "lstm_fwd", "lstm_bwd"),
                        ("pc_train_pca_gru", "gru_fwd", "gru_bwd")):
        batch = cfgs[p]["batch_size"]
        tr, va, te = (n_batches(lengths(p, key).values(), batch)
                      for key in ("train_seq_dict", "valid_seq_dict", "test_seq_dict"))
        expected[p] = {**none, fwd: 2 * (epochs * (tr + va) + te), bwd: 2 * epochs * tr,
                       "p2cp": epochs * va + te, "min_dist": 2 * te}
    test_lengths = lengths("pc_test_lstm", "test_seq_dict")
    te = n_batches(test_lengths.values(), cfgs["pc_test_lstm"]["batch_size"])
    expected["pc_test_lstm"] = {**none, "lstm_fwd": 2 * te, "p2cp": te, "min_dist": 2 * te}
    gen = cfgs["pc_generate"]
    sentences = DATABASE_COLLECTORS["gottingen"](corpus).collect_data(
        sequences_from_dict(corpus, gen["seq_dict"]))
    expected["pc_generate"] = {**none, "lstm_fwd": 2 * -(-len(sentences) // 8)}
    phase("pc", ae_valid_frame_batches=ae_va, ae_test_frame_batches=ae_te,
          latent_test_sentences=len(test_lengths), synthesis_sentences=len(sentences))

    modules = {"pc_norm_stats": calculate_normalization_statistics,
               "pc_train_pca": train_articulatory_pca,
               "pc_train_ae": train_principal_components_autoencoder,
               "pc_test_ae": test_principal_components_autoencoder,
               "pc_train_ae_gru": train_phoneme_to_principal_components,
               "pc_train_ae_lstm": train_phoneme_to_principal_components,
               "pc_train_pca_gru": train_phoneme_to_principal_components,
               "pc_test_lstm": test_phoneme_to_principal_components,
               "pc_generate": generate_vocal_tract_shape}
    results, launches, seconds = {}, {}, {}
    for p in PC_PATHS:
        reset_launch_counts()
        results[p], seconds[p] = run_cli(modules[p], os.path.join(tmp, f"{p}.yaml"), out[p])
        launches[p] = launch_counts()
        phase("pc", cli=p, seconds=f"{seconds[p]:.3f}",
              **{f"{k}_launches": v for k, v in launches[p].items() if v or expected[p][k]},
              **{f"{k}_expected": v for k, v in expected[p].items() if v})
        check(launches[p] == expected[p], f"{p}: kernel launches {launches[p]}, "
                                          f"expected {expected[p]}")
    check(launches["pc_train_ae_lstm"]["lstm_bwd"] > 0 and launches["pc_generate"]["lstm_fwd"] > 0,
          "the LSTM latent RNN launched no lstm kernel")

    # What the CLIs wrote.
    check(finite_npys(os.path.join(corpus, "normalization_statistics")) == 2 * len(arts),
          "normalization statistics")
    for part in ("encoder", "decoder"):
        check(os.path.isfile(os.path.join(pca, part)), f"train_articulatory_pca wrote no {part}")
    for sub in ("best/state.pt", "last/state.pt", "best_encoder", "best_decoder"):
        check(os.path.isfile(os.path.join(ae_ckpts, sub)), f"the AE train CLI wrote no {sub}")
    ae_tests = {p: os.path.join(out[p], "test_outputs") for p in ("pc_train_ae", "pc_test_ae")}
    for name in ("latents.npy", "latent_covariance.npy", "nomograms.npz", "test_results.json"):
        check(all(os.path.isfile(os.path.join(d, name)) for d in ae_tests.values()), name)
    check(os.path.isfile(os.path.join(ae_tests["pc_test_ae"], "latent_histograms.npz")),
          "latent_histograms.npz")
    ae_train, ae_test = flat(results["pc_train_ae"]), flat(results["pc_test_ae"])
    diff = max(abs(ae_test[k] - v) for k, v in ae_train.items())
    check(ae_test.keys() == ae_train.keys() and diff <= 1e-6 and
          all(np.isfinite(v) for v in ae_train.values()),
          f"the AE test CLI differs from the train CLI's final test by {diff}")
    phase("pc", cli="pc_test_ae", p2cp_mm=f"{results['pc_test_ae']['p2cp_mm']:.6g}",
          vs_train_cli_max_abs_diff=f"{diff:.3g}")
    n_arts = len(arts) + 1  # with the upper incisor
    for p in ("pc_train_ae_gru", "pc_train_ae_lstm", "pc_train_pca_gru", "pc_test_lstm"):
        frames_seen, tv_rows = check_test_outputs(os.path.join(out[p], "test_outputs", "0"),
                                                  test_lengths, n_arts)
        check(all(np.isfinite(v) for v in flat(results[p]).values()), f"{p}: non-finite results")
        phase("pc", cli=p, test_frames=frames_seen, tv_csv_rows=tv_rows,
              p2cp_mm=f"{results[p]['p2cp_mm']:.6g}")
    # The test config batches 8 sentences, the train config 12: the frozen
    # decoder's products and the batch reductions run at other shapes, so
    # the two agree to float32 rounding relative to each value (p2cp_mm is
    # tens of millimetres), not to 1e-6 absolute as the [cli] pair does.
    lstm_train, lstm_test = flat(results["pc_train_ae_lstm"]), flat(results["pc_test_lstm"])
    diff = max(abs(lstm_test[k] - v) / max(abs(v), 1.0) for k, v in lstm_train.items())
    phase("pc", test_cli_vs_train_cli_final_test_max_rel_diff=f"{diff:.3g}", tol=1e-6)
    check(lstm_test.keys() == lstm_train.keys() and diff <= 1e-6,
          f"the latent-RNN test CLI differs from the train CLI's final test by {diff} relative")
    synthesized = check_synthesis(gen["save_to"], sentences, n_arts)
    check(len(results["pc_generate"]) == len(sentences), "pc_generate: sentences written")
    phase("pc", cli="pc_generate", sentences=len(sentences), frames=synthesized, finite=True)
    return launches, seconds


# -- the transformer's KV-cached decode -----------------------------------------

def thesis_transformer(device, dropout=None):
    """The transformer of configs/model_free/train_transformer.yaml at full
    width (its dropout 0.1, inactive in eval mode, unless ``dropout`` is
    given), weights from seed 0."""
    cfg = config_file.load(os.path.join(THESIS_CONFIGS, "train_transformer.yaml"))
    kwargs = model_kwargs_from_cfg(cfg)
    if dropout is not None:
        kwargs["dropout"] = dropout
    return ArtSpeechTransformer(VOCAB, len(cfg["articulators"]), num_feat=2 * cfg.get("n_samples", 50),
                                **kwargs, generator=torch.Generator().manual_seed(0), device=device)


def decode_inputs(b, t, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, VOCAB, (b, t)).astype(np.int32), np.full(b, t, np.int32)


def decode_path():
    """make_fast_generate at T = 128, B = 12 and 64, f32 and bf16 caches:
    launches exactly 2 * layers * T flash_decode a batch and nothing else,
    finite contours, frames/s and the device breakdown with flash_decode's
    device ms and share of it a batch (f16 caches decode in [cli], through
    the transformer train CLI's final test). Returns the flash_decode
    launches of the four counted runs."""
    model = thesis_transformer(None)
    per_batch = 2 * model.num_layers * DECODE_T
    total = 0
    for b in DECODE_BATCHES:
        tokens, lengths = decode_inputs(b, DECODE_T, seed=b)
        for cache in ("float32", "bfloat16"):
            generate = make_fast_generate(model, cache)
            torch.cuda.synchronize()
            reset_launch_counts()
            out = generate(tokens, lengths)
            torch.cuda.synchronize()
            counts = launch_counts()
            expected = {**dict.fromkeys(KERNELS, 0), "flash_decode": per_batch}
            check(counts == expected, f"decode B={b} {cache}: launches {counts}, expected {expected}")
            check(tuple(out.shape) == (b, DECODE_T, 10, 2, 50) and bool(torch.isfinite(out).all()),
                  f"decode B={b} {cache}: shape {tuple(out.shape)} or non-finite contours")
            total += counts["flash_decode"]
            ms = host_ms(lambda: generate(tokens, lengths), 1)
            phase("decode", B=b, T=DECODE_T, cache=cache, decode_ms=f"{ms:.6g}",
                  frames_per_s=f"{b * DECODE_T / ms * 1e3:.6g}",
                  flash_decode_launches=counts["flash_decode"], expected=per_batch)
            kernels = device_breakdown(lambda: generate(tokens, lengths), ms, f"decode_B{b}_{cache}",
                                       steps=1, host_ops=False)
            if kernels:
                flash_ms = sum(k_ms for name, k_ms, _ in kernels if "flash_decode" in name)
                phase("decode", B=b, cache=cache, flash_decode_device_ms_per_batch=f"{flash_ms:.6g}",
                      flash_decode_share_of_busy=f"{flash_ms / sum(k[1] for k in kernels):.4f}")
    generate_band(model)
    return total


def generate_band(model):
    """The cached decode with f32 caches against the buffer re-decode at
    B = 12 over BAND_T: where the buffer is faster is make_auto_generate's
    band."""
    fast = make_fast_generate(model)
    band = []
    for t in BAND_T:
        tokens, lengths = decode_inputs(12, t, seed=t)
        src, src_lengths = torch.as_tensor(tokens, device="cuda"), torch.as_tensor(lengths, device="cuda")
        cached_ms = host_ms(lambda: fast(tokens, lengths), 1)
        buffer_ms = host_ms(lambda: model.generate(src, src_lengths), 1)
        if buffer_ms < cached_ms:
            band.append(t)
        phase("decode", band_sweep=f"B=12,T={t}", cached_f32_ms=f"{cached_ms:.6g}",
              buffer_ms=f"{buffer_ms:.6g}", faster="buffer" if buffer_ms < cached_ms else "cached")
    phase("decode", buffer_wins_at=band or "none")


def decode_against_cpu():
    """The same seeded full-width transformer on the card and on the CPU:
    one flash_decode_attend call at the B = 12 cross-channel shape; forward
    and encode (B = 2, T = 16, ragged) within TRANSFORMER_TOL; a T = 16
    decode with f32 caches whose every frame is within TRANSFORMER_TOL of
    what the CPU forward predicts from the card's earlier frames (the decode
    feeds each frame back and amplifies rounding noise from step to step, so
    the end-to-end gap is printed, and the first frame checked)."""
    k, v, q = flash_inputs(flash_groups(12)["inter"], torch.float32, seed=5)
    got = hopper_attention.flash_decode_attend(k, v, q, 77).cpu()
    cpu = hopper_attention.flash_decode_attend(k.cpu(), v.cpu(), q.cpu(), 77)
    attend_excess, attend_err = flash_excess(got, cpu)
    rng = np.random.default_rng(8)
    b, t = 2, 16
    tokens, lengths = rng.integers(0, VOCAB, (b, t)).astype(np.int32), np.array([t, 9], np.int32)
    tgt = rng.uniform(size=(b, t, 10, 100)).astype(np.float32)
    tgt_lengths = np.array([t, 11], np.int32)
    out = {}
    for device in ("cuda", "cpu"):
        model = thesis_transformer(device)
        args = [torch.as_tensor(x, device=device) for x in (tokens, tgt, lengths, tgt_lengths)]
        with torch.no_grad():
            out[device] = {"forward": model(*args).cpu(),
                           "encode": model.encode(args[0], args[2])[0].cpu(),
                           "decode": make_fast_generate(model, device=device)(tokens, lengths).cpu()}
        if device == "cpu":
            frames = out["cuda"]["decode"].reshape(b, t, 10, 100)
            shifted = torch.cat([torch.zeros_like(frames[:, :1]), frames[:, :-1]], dim=1)
            with torch.no_grad():
                teacher = model(torch.as_tensor(tokens), shifted, torch.as_tensor(lengths))
    errs = {k: (out["cuda"][k] - out["cpu"][k]).abs().max().item() for k in ("forward", "encode")}
    errs["decode_per_frame"] = (out["cuda"]["decode"] - teacher).abs().max().item()
    gap = (out["cuda"]["decode"] - out["cpu"]["decode"]).abs()
    errs["decode_first_frame"] = gap[:, 0].max().item()
    phase("decode", against_cpu_tol=TRANSFORMER_TOL, attend_max_abs_err=f"{attend_err:.3g}",
          decode_end_to_end_max_abs_diff=f"{gap.max().item():.3g}",
          **{f"max_abs_err_{k}": f"{v:.3g}" for k, v in errs.items()})
    check(attend_excess <= 0, f"flash_decode on the card and on the CPU disagree: {attend_err}")
    check(all(v <= TRANSFORMER_TOL for v in errs.values()), f"card and CPU transformer disagree: {errs}")


# -- transformer training ------------------------------------------------------

def transformer_state(device, dropout=None, lr=TRAIN["lr"]):
    """The thesis transformer with AdamW at the config's lr and wd (lr 1e-4,
    wd 1e-5, the same as the model-free trainer's)."""
    return state.create_train_state(thesis_transformer(device, dropout), lr, TRAIN["wd"])


def timed_step(step, st, batch, gen, tag, iters=5, breakdown=True):
    """Host-clock ms of a train step, its peak device memory and (optionally)
    its device breakdown."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = host_ms(lambda: step(st, batch, gen), iters)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if breakdown:
        device_breakdown(lambda: step(st, batch, gen), step_ms, tag, steps=2)
    return step_ms, peak_gib


def train_transformer_path():
    """One train step of the thesis transformer (dropout 0.1) at T = 128, B =
    12 and 64: exactly one forward and one backward train_attention launch a
    decoder layer and nothing else; its time, frames/s, peak memory and
    device breakdown, against the same step with the pair attention
    materialised in plain torch (no launch). Returns the launches of the
    counted steps."""
    total = dict.fromkeys(KERNELS, 0)
    for b in TRAIN_BATCHES:
        st = transformer_state(None)
        layers = st.model.num_layers
        batch = fixed_batch(b, TRAIN_T, seed=b, device="cuda", ragged=False)
        step = make_transformer_train_step(TO_MM)
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        reset_launch_counts()
        loss = step(st, batch, gen)["loss"].item()
        torch.cuda.synchronize()
        counts = launch_counts()
        expected = {**dict.fromkeys(KERNELS, 0), "train_attention_fwd": layers,
                    "train_attention_bwd": layers}
        check(counts == expected, f"train step B={b}: launches {counts}, expected {expected}")
        check(np.isfinite(loss), f"train step B={b}: loss {loss}")
        total = {k: total[k] + counts[k] for k in KERNELS}
        frames = b * TRAIN_T
        step_ms, peak = timed_step(step, st, batch, gen, f"train_transformer_B{b}")
        phase("train_transformer", B=b, T=TRAIN_T, pair_attention="kernel", loss=f"{loss:.6g}",
              step_ms=f"{step_ms:.6g}", frames_per_s=f"{frames / step_ms * 1e3:.6g}",
              peak_gib=f"{peak:.4g}", train_attention_fwd_launches=counts["train_attention_fwd"],
              train_attention_bwd_launches=counts["train_attention_bwd"], expected=layers)
        # The alternative the port does not take: the pair attention in
        # plain torch, scores materialised, autograd through its ops.
        saved = hopper_train_attention.fused_causal_attend
        hopper_train_attention.fused_causal_attend = hopper_train_attention.fused_causal_attend_reference
        try:
            reset_launch_counts()
            mat_ms, mat_peak = timed_step(step, st, batch, gen,
                                          f"train_transformer_B{b}_materialised")
            check(launch_counts() == dict.fromkeys(KERNELS, 0), "the materialised step launched")
        finally:
            hopper_train_attention.fused_causal_attend = saved
        phase("train_transformer", B=b, T=TRAIN_T, pair_attention="materialised_plain_torch",
              step_ms=f"{mat_ms:.6g}", frames_per_s=f"{frames / mat_ms * 1e3:.6g}",
              peak_gib=f"{mat_peak:.4g}", kernel_path_faster=step_ms < mat_ms)
        del st
    accumulation_sweep()
    return total


def accumulation_sweep():
    """The B = 64 step split into microbatches of MICROBATCHES sentences
    (accum_steps 64 // mb), each with its launch count checked."""
    b = TRAIN_BATCHES[-1]
    st = transformer_state(None)
    layers = st.model.num_layers
    batch = fixed_batch(b, TRAIN_T, seed=b, device="cuda", ragged=False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    steps = {mb: make_transformer_train_step(TO_MM, accum_steps=b // mb) for mb in MICROBATCHES}
    times, peaks = {}, {}
    for mb in MICROBATCHES:
        reset_launch_counts()
        steps[mb](st, batch, gen)
        torch.cuda.synchronize()
        counts = launch_counts()
        check(counts["train_attention_fwd"] == counts["train_attention_bwd"] == layers * b // mb,
              f"accum sweep microbatch {mb}: launches {counts}")
        times[mb], peaks[mb] = timed_step(steps[mb], st, batch, gen, "", iters=2, breakdown=False)
    for mb in MICROBATCHES:
        phase("train_transformer", sweep=f"B={b},T={TRAIN_T}", microbatch=mb, accum_steps=b // mb,
              step_ms=f"{times[mb]:.6g}", frames_per_s=f"{b * TRAIN_T / times[mb] * 1e3:.6g}",
              peak_gib=f"{peaks[mb]:.4g}")
    phase("train_transformer", sweep_fastest_microbatch=min(times, key=times.get))


def transformer_loss_falls():
    st = transformer_state(None, lr=1e-3)
    batch = fixed_batch(TRAIN["batch"], TRAIN_T, seed=7, device="cuda", ragged=False)
    step = make_transformer_train_step(TO_MM)
    gen = torch.Generator(device="cuda").manual_seed(0)
    losses = [step(st, batch, gen)["loss"].item() for _ in range(20)]
    phase("train_transformer", fixed_batch_lr=1e-3, dropout=TRAIN["dropout"],
          loss_first=f"{losses[0]:.6g}", loss_last=f"{losses[-1]:.6g}",
          ratio=f"{losses[-1] / losses[0]:.4f}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"loss did not fall: {losses}")


def transformer_train_against_cpu():
    """One transformer train step (dropout 0, B=2, T=32 ragged, full width,
    the same seeded weights) on the card and on the CPU, and its gradients in
    float64 on the CPU (the pair attention materialised, the kernels being
    float32 only).

    The ArtSpeech step's rule (every gradient within 1e-4 relative) does
    not hold for this model in float32 on any device: its LayerNorms take
    the variance as E[x^2] - E[x]^2, as the JAX package does, and that
    cancellation plus ReLU units within rounding of zero put the CPU's own
    float32 gradients up to 1e-2 from float64 on a tensor (both figures are
    printed). So:
    - the metrics within 1e-4 relative;
    - the card's gradients no further from float64 (global relative L2 over
      all parameters) than twice the CPU's, or 1e-4;
    - the updated parameters where both sides' gradients have one sign and
      |g| >= 100 * eps: AdamW's first update moves a component by
      lr * g / (|g| + eps) (and the same weight decay on both sides), which
      two same-sign gradients of |g| >= 100 * eps can part by at most
      lr * 1e-2, so a larger gap is the optimizer's; where only the CPU's
      |g| reaches 100 * eps, that bound does not hold (a card gradient of
      1e-7 moves its component by 0.91 lr, a CPU one of 1e-6 by 0.99 lr),
      so there the card's gradient must be no further from float64 than
      the CPU's, or the parameters within lr * 1e-2 all the same; and every
      component whose sign differs holds a gradient below 1e-2 of its
      tensor's largest;
    - the attention key biases' gradients (exactly zero in exact arithmetic)
      below 1e-6 of the largest gradient on both sides.
    The per-tensor relative figures are printed."""
    transformer_step_against_f64(fixed_batch(2, 32, seed=9, device="cpu"), "train_transformer",
                                 "dropout=0,B=2,T=32")


def transformer_step_against_f64(batch, tag, label):
    """transformer_train_against_cpu's step and rules on a CPU ``batch``."""
    out = {}
    for device in ("cuda", "cpu"):
        st = transformer_state(device, dropout=0.0)
        metrics = make_transformer_train_step(TO_MM, with_p2cp=True, device=device)(
            st, {k: v.to(device) for k, v in batch.items()})
        out[device] = ({k: v.item() for k, v in metrics.items()},
                       {n: p.grad.cpu().double() for n, p in st.model.named_parameters()},
                       {n: p.detach().cpu() for n, p in st.model.named_parameters()})
    model = thesis_transformer("cpu", dropout=0.0).double().train()
    saved = hopper_train_attention.fused_causal_attend
    hopper_train_attention.fused_causal_attend = hopper_train_attention.fused_causal_attend_reference
    try:
        targets = batch["targets"].double()
        outputs = model(batch["tokens"], shift_targets_right(targets), batch["lengths"],
                        batch["lengths"])
        masked_euclidean_loss(outputs, targets, batch["lengths"]).backward()
    finally:
        hopper_train_attention.fused_causal_attend = saved
    exact = {n: p.grad for n, p in model.named_parameters()}
    step_against_f64(tag, label, out, exact, zero={n for n in exact if n.endswith("key_bias")})


def long_bucket_batch():
    """The batch BucketedLoader makes of LONG_B sentences past the longest
    default bucket (LONG_SENTENCE and LONG_SENTENCE - 11 frames), on the
    CPU: both in the bucket the loader adds for them."""
    corpus = Corpus(LONG_B, seed=17, lengths=(LONG_SENTENCE, LONG_SENTENCE - 11))
    batch, _ = next(iter(BucketedLoader(corpus, LONG_B, shuffle=False)))
    return {k: torch.as_tensor(batch[k]) for k in ("tokens", "targets", "lengths")}


def long_bucket_path():
    """The thesis transformer's train step (dropout 0.1) on long_bucket_batch
    (L = TRAIN_ATTN_LONG_L[0], past the resident kernels' MAX_L): exactly one
    forward and one backward train_attention launch a decoder layer, on the
    streamed kernels, a finite loss, its time, device breakdown and peak
    memory; then the same step
    at dropout 0 on the card and on the CPU against float64
    (transformer_step_against_f64). Returns the launches of the counted step."""
    batch = long_bucket_batch()
    l = batch["tokens"].shape[1]
    check(l == TRAIN_ATTN_LONG_L[0] and not hopper_train_attention.resident(l, HD),
          f"the loader's long bucket is L={l}, expected {TRAIN_ATTN_LONG_L[0]} on the streamed "
          f"kernels")
    st = transformer_state(None)
    layers = st.model.num_layers
    step = make_transformer_train_step(TO_MM)
    gen = torch.Generator(device="cuda").manual_seed(0)
    on_card = {k: v.cuda() for k, v in batch.items()}
    torch.cuda.synchronize()
    reset_launch_counts()
    loss = step(st, on_card, gen)["loss"].item()
    torch.cuda.synchronize()
    counts = launch_counts()
    expected = {**dict.fromkeys(KERNELS, 0), "train_attention_fwd": layers,
                "train_attention_bwd": layers}
    check(counts == expected, f"long-bucket step: launches {counts}, expected {expected}")
    check(np.isfinite(loss), f"long-bucket step: loss {loss}")
    step_ms, peak = timed_step(step, st, on_card, gen, f"train_transformer_L{l}", iters=3,
                               breakdown=False)
    device_breakdown(lambda: step(st, on_card, gen), step_ms, f"train_transformer_L{l}", steps=1,
                     host_ops=False)
    phase("train_transformer", long_bucket=f"B={LONG_B},L={l}",
          lengths=",".join(str(int(n)) for n in batch["lengths"]), dropout=TRAIN["dropout"],
          loss=f"{loss:.6g}", step_ms=f"{step_ms:.6g}",
          frames_per_s=f"{int(batch['lengths'].sum()) / step_ms * 1e3:.6g}",
          peak_gib=f"{peak:.4g}", train_attention_fwd_launches=counts["train_attention_fwd"],
          train_attention_bwd_launches=counts["train_attention_bwd"], expected=layers)
    del st
    transformer_step_against_f64(batch, "train_transformer",
                                 f"long_bucket,dropout=0,B={LONG_B},L={l}")
    return counts


def step_against_f64(tag, label, out, exact, zero=frozenset(), own=frozenset()):
    """Hold one train step on the card to the same step on the CPU and to
    float64 gradients (the rules of transformer_train_against_cpu).

    ``out[device]`` is (metrics, float64 copies of the gradients, the
    updated parameters) of the step on ``cuda`` and on ``cpu``; ``exact``
    the float64 gradients; ``zero`` the parameters whose exact gradient is
    zero (held to 1e-6 of the largest gradient instead); ``own`` those the
    caller holds by a rule of its own (left out here)."""
    exact = {n: g for n, g in exact.items() if n not in own}

    def global_err(grads):
        num = sum(((grads[n] - exact[n]) ** 2).sum().item() for n in exact if n not in zero)
        return (num / sum((exact[n] ** 2).sum().item() for n in exact if n not in zero)) ** 0.5

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()

    card, cpu = out["cuda"], out["cpu"]
    metric_err = max(abs(card[0][k] - v) / max(abs(v), 1e-30) for k, v in cpu[0].items())
    err_card, err_cpu = global_err(card[1]), global_err(cpu[1])
    param_err, flips, flip_share, cpu_only, further = 0.0, 0, 0.0, 0, 0
    for n, p in cpu[2].items():
        if n in own:
            continue
        g_card, g_cpu = card[1][n], cpu[1][n]
        moved = (card[2][n] - p).abs() / TRAIN["lr"]
        agree = (torch.sign(g_card) == torch.sign(g_cpu)) & (g_cpu.abs() >= 100 * 1e-8)
        same = agree & (g_card.abs() >= 100 * 1e-8)
        if same.any():
            param_err = max(param_err, moved[same].max().item())
        # Only the CPU's |g| past 100 eps: the card's gradient as near float64
        # as the CPU's, or the update within lr * 1e-2.
        lone = agree & (g_card.abs() < 100 * 1e-8)
        cpu_only += int(lone.sum())
        further += int((lone & ((g_card - exact[n]).abs() > (g_cpu - exact[n]).abs())
                        & (moved > 1e-2)).sum())
        flipped = torch.sign(g_card) != torch.sign(g_cpu)
        if flipped.any() and n not in zero:
            flips += int(flipped.sum())
            flip_share = max(flip_share, (g_cpu.abs()[flipped].max() / g_cpu.abs().max()).item())
    largest = max(g.abs().max().item() for g in exact.values())
    zero_share = max((out[d][1][n].abs().max().item() for d in out for n in zero),
                     default=0.0) / largest
    per_tensor = {"card_vs_cpu": max(rel(card[1][n], cpu[1][n]) for n in exact if n not in zero),
                  "cpu_vs_f64": max(rel(cpu[1][n], exact[n]) for n in exact if n not in zero)}
    phase(tag, against_cpu=label, metric_rel_err=f"{metric_err:.3g}",
          grads_vs_f64_global_rel_card=f"{err_card:.3g}", grads_vs_f64_global_rel_cpu=f"{err_cpu:.3g}",
          grads_card_vs_cpu_max_rel_per_tensor=f"{per_tensor['card_vs_cpu']:.3g}",
          grads_cpu_vs_f64_max_rel_per_tensor=f"{per_tensor['cpu_vs_f64']:.3g}",
          params_diff_over_lr_same_sign_g_ge_100eps=f"{param_err:.3g}",
          cpu_only_g_ge_100eps=cpu_only, cpu_only_card_further_from_f64=further, sign_flips=flips,
          sign_flip_max_share=f"{flip_share:.3g}",
          **({"zero_grads_over_largest": f"{zero_share:.3g}"} if zero else {}))
    check(metric_err <= 1e-4, f"card and CPU {tag} steps disagree on the metrics: {metric_err}")
    check(err_card <= max(2 * err_cpu, 1e-4),
          f"the card's gradients are further from float64 ({err_card}) than twice the CPU's ({err_cpu})")
    check(param_err <= 1e-2, f"card and CPU updated parameters part by {param_err} lr")
    check(further == 0, f"{further} components whose |g| passes 100 eps on the CPU only: the "
                        f"card's gradient further from float64 than the CPU's and the update "
                        f"beyond lr * 1e-2")
    check(flip_share <= 1e-2, f"a gradient of {flip_share} of its tensor's largest flips sign")
    check(zero_share <= 1e-6, f"exactly-zero gradients reach {zero_share} of the largest")


# -- the latent RNN at full width ------------------------------------------------

def latent_config():
    """train_autoencoder_based.yaml and its indices_dict (10 articulators,
    latent 35)."""
    cfg = config_file.load(os.path.join(PC_CONFIGS, "train_autoencoder_based.yaml"))
    return cfg, normalize_indices_dict(cfg["indices_dict"])


def pc_stats():
    """Seeded per-articulator statistics (10, 2, 50): means of contours in
    [0, 1], standard deviations of a few hundredths."""
    rng = np.random.default_rng(4)
    mean = rng.uniform(0.3, 0.7, (len(RECOGNITION_ARTICULATORS), 2, 50)).astype(np.float32)
    std = rng.uniform(0.02, 0.08, (len(RECOGNITION_ARTICULATORS), 2, 50)).astype(np.float32)
    return mean, std


def latent_loss(device, dtype=torch.float32, recognizer_fn=None, beta4=0.0):
    """The config's composite loss (beta 0.5 / 3 / 1, the LA, TTCD and TBCD
    critical loss; with ``recognizer_fn``, ``beta4`` times its feature term)
    over a frozen autoencoder at the config's widths (in 100, hidden 50) with
    seeded weights. Returns (loss_fn, decode, mean, std), the statistics as
    numpy."""
    cfg, indices = latent_config()
    ae = MultiArticulatorAutoencoder(indices, 100, 50, generator=torch.Generator().manual_seed(4),
                                     device=device).to(dtype).requires_grad_(False)
    mean, std = pc_stats()
    loss_fn = make_autoencoder_loss(
        ae.encode, ae.decode, sorted(cfg["TV_to_phoneme_map"]), sorted(indices),
        beta1=cfg["beta1"], beta2=cfg["beta2"], beta3=cfg["beta3"], beta4=beta4,
        rescale_factor=cfg["rescale_factor"], recognizer_fn=recognizer_fn,
        denorm_mean=torch.as_tensor(mean, dtype=dtype, device=device),
        denorm_std=torch.as_tensor(std, dtype=dtype, device=device))
    return loss_fn, ae.decode, mean, std


def latent_model(device, rnn="LSTM"):
    """The config's latent RNN (embed 64, hidden 128, its rnn_dropout 0) with
    ``rnn``, weights from seed 0."""
    _, indices = latent_config()
    return PrincipalComponentsArtSpeech(VOCAB, indices, rnn=rnn,
                                        generator=torch.Generator().manual_seed(0), device=device)


def pc_batch(b, t, seed, device, ragged=True):
    """A seeded latent-RNN batch: fixed_batch's tokens and smooth contours,
    normalized with pc_stats; incisor references; critical frames of the
    three TVs drawn at random."""
    batch = fixed_batch(b, t, seed, "cpu", ragged)
    mean, std = pc_stats()
    rng = np.random.default_rng(seed)
    references = np.stack([smooth_contours(t, rng, n_art=1) for _ in range(b)])
    batch.update(targets=(batch["targets"] - torch.from_numpy(mean)) / torch.from_numpy(std),
                 references=torch.from_numpy(references),
                 critical_masks=torch.from_numpy(rng.integers(0, 2, (b, 3, t)).astype(np.int32)))
    return {k: v.to(device) for k, v in batch.items()}


def latent_rnn_path():
    """The full-width LSTM latent RNN on the card: one train step (AdamW at
    the config's lr and wd) at T = 128 and B = 12, 64 with exactly 2 forward
    and 2 backward lstm launches and nothing else; the synthesis forward
    (RNN -> frozen decoder -> denorm) at B = 16 with exactly 2 forward
    launches; each with frames/s and its device breakdown. Returns the
    launches of one pass of each."""
    cfg, _ = latent_config()
    loss_fn, decode, mean, std = latent_loss("cuda")
    step = make_latent_rnn_train_step(loss_fn, decode, mean, std, TO_MM, cfg["rescale_factor"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    total = dict.fromkeys(KERNELS, 0)
    for b in LATENT_BATCHES:
        st = state.create_train_state(latent_model("cuda"), cfg["learning_rate"], cfg["weight_decay"])
        batch = pc_batch(b, LATENT_T, seed=b, device="cuda", ragged=False)
        reset_launch_counts()
        loss = step(st, batch, gen)["loss"].item()
        counts = launch_counts()
        expected = {**dict.fromkeys(KERNELS, 0), "lstm_fwd": 2, "lstm_bwd": 2}
        check(counts == expected, f"latent RNN train step B={b}: launches {counts}")
        total = {k: total[k] + v for k, v in counts.items()}
        step_ms, peak_gib = timed_step(step, st, batch, gen, f"latent_rnn_train_B{b}")
        phase("latent_rnn", step="train", B=b, T=LATENT_T, rnn="LSTM", loss=f"{loss:.6g}",
              step_ms=f"{step_ms:.6g}", frames_per_s=f"{b * LATENT_T / step_ms * 1e3:.6g}",
              lstm_fwd_launches=counts["lstm_fwd"], lstm_bwd_launches=counts["lstm_bwd"],
              peak_gib=f"{peak_gib:.3f}")
    model = latent_model("cuda")
    forward = make_latent_rnn_synthesis_forward(
        model, decode, torch.as_tensor(mean, device="cuda"), torch.as_tensor(std, device="cuda"),
        rescale_factor=cfg["rescale_factor"])
    batch = pc_batch(SYNTH_B, LATENT_T, seed=16, device="cuda", ragged=False)

    def synthesize():
        with torch.inference_mode():
            return forward(batch["tokens"], batch["lengths"])

    reset_launch_counts()
    shapes = synthesize()
    counts = launch_counts()
    check(counts == {**dict.fromkeys(KERNELS, 0), "lstm_fwd": 2},
          f"latent RNN synthesis forward: launches {counts}")
    check(tuple(shapes.shape) == (SYNTH_B, LATENT_T, 10, 2, 50) and bool(torch.isfinite(shapes).all()),
          "synthesis shapes")
    total = {k: total[k] + v for k, v in counts.items()}
    synth_ms = host_ms(synthesize, 10)
    phase("latent_rnn", step="synthesis", B=SYNTH_B, T=LATENT_T, rnn="LSTM",
          step_ms=f"{synth_ms:.6g}", frames_per_s=f"{SYNTH_B * LATENT_T / synth_ms * 1e3:.6g}",
          lstm_fwd_launches=counts["lstm_fwd"], shape=tuple(shapes.shape))
    device_breakdown(synthesize, synth_ms, "latent_rnn_synthesis_B16")
    return total


def latent_rnn_loss_falls():
    cfg, _ = latent_config()
    loss_fn, decode, mean, std = latent_loss("cuda")
    st = state.create_train_state(latent_model("cuda"), 1e-3, cfg["weight_decay"])
    step = make_latent_rnn_train_step(loss_fn, decode, mean, std, TO_MM, cfg["rescale_factor"])
    batch = pc_batch(LATENT_BATCHES[0], LATENT_T, seed=3, device="cuda")
    losses = [step(st, batch)["loss"].item() for _ in range(20)]
    phase("latent_rnn", fixed_batch_lr=1e-3, loss_first=f"{losses[0]:.6g}",
          loss_last=f"{losses[-1]:.6g}", ratio=f"{losses[-1] / losses[0]:.4f}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"loss did not fall: {losses}")


def latent_rnn_train_against_cpu():
    """One latent-RNN train step (LSTM, B=2, T=32 ragged, full width, the
    same seeded weights) on the card and on the CPU, held to the float64
    gradients on the CPU as the transformer's step is
    (transformer_train_against_cpu): the predictor's LayerNorms take the
    variance as E[x^2] - E[x]^2, as the JAX package's do."""
    cfg, _ = latent_config()
    batch = pc_batch(2, 32, seed=9, device="cpu")
    out = {}
    for device in ("cuda", "cpu"):
        loss_fn, decode, mean, std = latent_loss(device)
        st = state.create_train_state(latent_model(device), TRAIN["lr"], TRAIN["wd"])
        metrics = make_latent_rnn_train_step(loss_fn, decode, mean, std, TO_MM,
                                             cfg["rescale_factor"], with_p2cp=True, device=device)(
            st, {k: v.to(device) for k, v in batch.items()})
        out[device] = ({k: v.item() for k, v in metrics.items()},
                       {n: p.grad.cpu().double() for n, p in st.model.named_parameters()},
                       {n: p.detach().cpu() for n, p in st.model.named_parameters()})
    model = latent_model("cpu").double().train()
    loss_fn, _, _, _ = latent_loss("cpu", torch.float64)
    pcs = model(batch["tokens"], batch["lengths"])
    loss_fn(pcs, batch["targets"].double(), batch["references"].double(), batch["lengths"],
            batch["critical_masks"]).backward()
    step_against_f64("latent_rnn", "rnn=LSTM,B=2,T=32", out,
                     {n: p.grad for n, p in model.named_parameters()})


# -- the phoneme recognizer (DeepSpeech2) ------------------------------------------

def write_air_columns(corpus):
    """Seeded air_column/{frame}.npy arrays (2 walls, 2, 100) beside every
    sequence's contours, as the recognizer's air-column feature reads them."""
    rng = np.random.default_rng(16)
    subject_dir = os.path.join(corpus, CLI_CORPUS["subject"])
    for sequence in CLI_CORPUS["sequences"]:
        seq_dir = os.path.join(subject_dir, sequence)
        frames = sorted({name.split("_")[0]
                         for name in os.listdir(os.path.join(seq_dir, "inference_contours"))})
        os.makedirs(os.path.join(seq_dir, "air_column"), exist_ok=True)
        for frame in frames:
            np.save(os.path.join(seq_dir, "air_column", f"{frame}.npy"),
                    rng.uniform(0.2, 0.8, (2, 2, 100)).astype(np.float32))


def rec_batches(corpus, seq_dict, feature, batch_size):
    """Batches RecognitionLoader makes of a split: sentences grouped by
    bucket (melspec lengths from the sentences' audio durations)."""
    per_bucket = {}
    for item in DATABASE_COLLECTORS["gottingen"](corpus).collect_data(
            sequences_from_dict(corpus, seq_dict)):
        if feature == "melspec":
            length = int(round(item["audio_duration"] * 16000)) // 256 + 1
        else:
            length = len(item["frame_ids"])
        bucket = pick_bucket(length, REC_BUCKETS)
        per_bucket[bucket] = per_bucket.get(bucket, 0) + 1
    return sum(-(-n // batch_size) for n in per_bucket.values())


def rec_config(name, tmp, corpus, vocab_path, **changes):
    """configs/phoneme_recognition/<name>.yaml written into tmp with the
    corpus paths, the database, the voicing file (where the config names
    one) and ``changes`` replaced."""
    original = config_file.load(os.path.join(REC_CONFIGS, f"{name}.yaml"))
    keys = {"datadir": corpus, "database_name": "gottingen", "vocab_filepath": vocab_path,
            **({"voicing_filepath": REC_VOICING} if "voicing_filepath" in original else {}),
            **changes}
    path = os.path.join(tmp, f"rec_{name}.yaml")
    return path, thesis_config(name, path, keys, folder=REC_CONFIGS)


def check_rec_outputs(out_dir, result, train):
    """The artifacts of a recognition test (and of a train run, its
    checkpoints), with finite numbers equal to what the CLI returned."""
    outputs = os.path.join(out_dir, "test_outputs")
    names = set(os.listdir(outputs))
    check({"substitution_matrix.npy", "grouped_confusion_matrix.npy", "test_results.json",
           "predictions.json", "features.npz"} <= names, f"{outputs}: {sorted(names)}")
    with open(os.path.join(outputs, "test_results.json")) as f:
        check(json.load(f) == result, f"{outputs}/test_results.json")
    check(set(result) == {"loss", "edit_distance", "word_info_lost"}
          and all(np.isfinite(v) for v in result.values()), f"{out_dir}: {result}")
    for name in ("substitution_matrix.npy", "grouped_confusion_matrix.npy"):
        check(np.isfinite(np.load(os.path.join(outputs, name))).all(), f"{outputs}/{name}")
    check(np.isfinite(np.load(os.path.join(outputs, "features.npz"))["features"]).all(),
          f"{outputs}/features.npz")
    if train:
        for sub in ("best/state.pt", "best/aux.json", "last/state.pt", "last/aux.json"):
            check(os.path.isfile(os.path.join(out_dir, "checkpoints", sub)), f"{out_dir}: {sub}")


def recognizer_path(tmp, corpus, vocab_path):
    """The recognizer's six train configs through the train CLI and the four
    test configs through the test CLI on their checkpoints, over the [cli]
    corpus with seeded air columns. Each run's GRU launches against counts
    from the corpus's batches (a forward launch per recurrent layer and
    batch of every train, valid and test pass; a backward one per layer and
    train batch; nothing else), its files and each test CLI against its
    train CLI's final test. Returns the launches and wall seconds of each
    run, and the train_vocal_tract config for the card-vs-CPU checks."""
    write_air_columns(corpus)
    none = dict.fromkeys(KERNELS, 0)
    results, launches, seconds, expected, cfgs, outs = {}, {}, {}, {}, {}, {}
    runs = [(name, train_phoneme_recognition, {"num_epochs": epochs})
            for name, epochs in REC_TRAIN_EPOCHS.items()]
    runs += [(name, test_phoneme_recognition,
              {"state_dict_filepath": os.path.join(tmp, f"rec_{train}", "checkpoints", "best",
                                                   "state")})
             for name, train in REC_TESTS.items()]
    for name, module, changes in runs:
        p = f"rec_{name}"
        path, cfg = rec_config(name, tmp, corpus, vocab_path, **changes)
        cfgs[p], outs[p] = cfg, os.path.join(tmp, p)
        layers = cfg["model_params"]["num_rnn_layers"]
        bs, feature = cfg["batch_size"], cfg["feature"]
        test_batches = rec_batches(corpus, cfg["test_seq_dict"], feature, bs)
        if module is train_phoneme_recognition:
            train_batches = rec_batches(corpus, cfg["train_seq_dict"], feature, bs)
            valid_batches = rec_batches(corpus, cfg["valid_seq_dict"], feature, bs)
            epochs = cfg["num_epochs"]
            expected[p] = {**none,
                           "gru_fwd": layers * (epochs * (train_batches + valid_batches)
                                                + test_batches),
                           "gru_bwd": layers * epochs * train_batches}
        else:
            expected[p] = {**none, "gru_fwd": layers * test_batches}
        reset_launch_counts()
        results[p], seconds[p] = run_cli(module, path, outs[p])
        launches[p] = launch_counts()
        phase("recognizer", cli=p, feature=feature, seconds=f"{seconds[p]:.3f}",
              **{f"{k}_launches": v for k, v in launches[p].items() if v or expected[p][k]},
              **{f"{k}_expected": v for k, v in expected[p].items() if v},
              loss=f"{results[p]['loss']:.6g}",
              edit_distance=f"{results[p]['edit_distance']:.6g}")
        check(launches[p] == expected[p], f"{p}: kernel launches {launches[p]}, "
                                          f"expected {expected[p]}")
        check_rec_outputs(outs[p], results[p], module is train_phoneme_recognition)
        if module is train_phoneme_recognition:
            with open(os.path.join(outs[p], "run", "metrics.jsonl")) as f:
                records = [json.loads(line) for line in f]
            check([r["step"] for r in records] == list(range(cfg["num_epochs"])),
                  f"{p}: metrics.jsonl epochs")
    for name, train_name in REC_TESTS.items():
        test, train = results[f"rec_{name}"], results[f"rec_{train_name}"]
        diff = abs(test["loss"] - train["loss"]) / max(abs(train["loss"]), 1e-30)
        phase("recognizer", test_cli=name, vs_train_cli_final_test_loss_rel_diff=f"{diff:.3g}",
              same_edit_distance=test["edit_distance"] == train["edit_distance"])
        check(diff <= 1e-5 and test["edit_distance"] == train["edit_distance"]
              and test["word_info_lost"] == train["word_info_lost"],
              f"{name} differs from {train_name}'s final test: {test} vs {train}")
    return launches, seconds, cfgs["rec_train_vocal_tract"]


def rec_model(cfg, device, seed=0, **overrides):
    """The config's DeepSpeech2 at full width with seeded weights."""
    params = {**model_kwargs_from_cfg(cfg, "model_params"), **overrides}
    return DeepSpeech2(num_classes=len(load_vocabulary(cfg["vocab_filepath"])), **params,
                       generator=torch.Generator().manual_seed(seed), device=device)


def recognizer_eval_against_cpu(dataset, cfg, tag, label):
    """One batch of ``dataset``'s vocal-tract features, at ``cfg``'s widths
    (train_vocal_tract's: 4 residual layers of 32 channels, the Adapter 500
    -> 80, 2 GRU layers of 64) and its use_voicing, through the eval step on
    the card and on the CPU, the same seeded weights: logits and log-probs
    within REC_TOL of max(|ref|, 1), the loss within REC_TOL relative, the
    same greedy ids."""
    batch, _ = next(iter(RecognitionLoader(dataset, "vocal_tract", cfg["batch_size"],
                                           shuffle=False)))
    use_voicing = cfg.get("use_voicing", False)
    out = {}
    for device in ("cuda", "cpu"):
        model = rec_model(cfg, device, seed=3)
        step = make_recognition_eval_step("ctc", "ctc_target", feature="vocal_tract",
                                          use_voicing=use_voicing, device=device)
        with torch.no_grad():
            logits = model(torch.as_tensor(batch["features"], device=device),
                           voicing=(torch.as_tensor(batch["voicing"], device=device)
                                    if use_voicing else None),
                           lengths=torch.as_tensor(batch["input_lengths"], device=device))
        result = step(state.TrainState(model=model, optimizer=None), batch)
        out[device] = (logits.cpu(), {k: v.cpu() for k, v in result.items()})
    (logits, card), (ref_logits, cpu) = out["cuda"], out["cpu"]
    errs = {"logits": rel_err(logits, ref_logits),
            "log_probs": rel_err(card["log_probs"], cpu["log_probs"]),
            "loss": abs(card["loss"].item() - cpu["loss"].item()) / abs(cpu["loss"].item())}
    same_ids = torch.equal(card["decoded"], cpu["decoded"]) and torch.equal(
        card["decoded_lengths"], cpu["decoded_lengths"])
    phase(tag, against_cpu="eval_step,{},B={},T={},use_voicing={}".format(
        label, *batch["input_lengths"].shape, batch["features"].shape[-1], use_voicing),
          **{f"{k}_rel_err": f"{v:.3g}" for k, v in errs.items()}, tol=REC_TOL,
          same_greedy_ids=same_ids)
    check(all(v <= REC_TOL for v in errs.values()) and same_ids,
          f"the recognizer's eval step on the card differs from the CPU ({label}): {errs}, "
          f"ids {same_ids}")


def rec_batch(b, t, d, n_classes, seed, device, ragged=True, n_labels=None):
    """A seeded vocal-tract-shaped batch (B, 2, d, T) as the collate pads
    it (-1.0 past each row's length), voicing, and CTC targets of
    ``n_labels`` (default T // 4) ids in [2, n_classes) a row."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(t // 2, t + 1, b) if ragged else np.full(b, t)
    lengths[0] = t
    pad = np.arange(t)[None, :] >= lengths[:, None]
    features = np.where(pad[:, None, None, :], np.float32(-1.0),
                        rng.uniform(0.0, 1.0, (b, 2, d, t)).astype(np.float32))
    n = n_labels or t // 4
    targets = rng.integers(2, n_classes, (b, n)).astype(np.int32)
    batch = {"features": features, "input_lengths": lengths.astype(np.int32),
             "voicing": np.where(pad, np.float32(-1.0), np.float32(0.0)),
             "ctc_target": targets, "ctc_target_lengths": np.full(b, n, np.int32)}
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def recognizer_train_against_cpu(cfg):
    """One recognizer train step (train_vocal_tract's widths, dropout 0,
    margins 0, AdamW at lr 1e-4, B = 2, T = 32 ragged, CTC) on the card and
    on the CPU, the same seeded weights, held to float64 gradients on the
    CPU by the transformer's rules (step_against_f64). Each residual block's
    first conv bias has an exactly-zero gradient (its LayerNorm over D
    removes any shift along D). The conv stem's bias is held by its own
    rule: on padded frames the Adapter's LayerNorm sees a constant row and
    gives the stem zeros, the stem gives the first residual LayerNorm rows
    constant along D, whose Jacobian is 1/sqrt(eps) = 1000 times larger,
    and the bias's gradient is the sum over (B, T, D) of those terms, which
    cancel to its small exact value. Its float32 error on any device is
    then rounding of terms whose magnitudes sum to S (the float64 sum of
    |dL/d(stem output)| over the channel's positions): each side must be
    within REC_BIAS_ROUNDING * 2^-24 * S of float64, channel by channel
    (both read about 0.3 of it at this seed, PERF.md §6)."""
    batch = rec_batch(2, 32, cfg["model_params"]["num_features"],
                      len(load_vocabulary(cfg["vocab_filepath"])), seed=11, device="cpu")
    out = {}
    for device in ("cuda", "cpu"):
        st = state.create_train_state(rec_model(cfg, device, seed=4, dropout=0.0),
                                      TRAIN["lr"], cfg["weight_decay"])
        metrics = make_recognition_train_step("ctc", "ctc_target", feature="vocal_tract",
                                              device=device)(st, batch)
        out[device] = ({k: v.item() for k, v in metrics.items()},
                       {n: p.grad.cpu().double() for n, p in st.model.named_parameters()},
                       {n: p.detach().cpu() for n, p in st.model.named_parameters()})
    model = rec_model(cfg, "cpu", seed=4, dropout=0.0).double().train()
    stem = {}

    def keep_stem_output(module, inputs, output):
        output.retain_grad()
        stem["out"] = output

    hook = model.conv.register_forward_hook(keep_stem_output)
    logits = model(batch["features"].double(), lengths=batch["input_lengths"])
    hook.remove()
    ctc_loss(torch.log_softmax(logits, -1), batch["ctc_target"], batch["input_lengths"],
             batch["ctc_target_lengths"]).backward()
    exact = {n: p.grad for n, p in model.named_parameters()}
    scale = 2.0**-24 * stem["out"].grad.abs().sum(dim=(0, 2, 3))
    bias_err = {d: ((out[d][1]["conv.bias"] - exact["conv.bias"]).abs() / scale).max().item()
                for d in out}
    phase("recognizer", conv_stem_bias_err_over_rounding_card=f"{bias_err['cuda']:.3g}",
          conv_stem_bias_err_over_rounding_cpu=f"{bias_err['cpu']:.3g}",
          bound=REC_BIAS_ROUNDING, rounding_scale_max=f"{scale.max().item():.3g}",
          conv_stem_bias_exact_max=f"{exact['conv.bias'].abs().max().item():.3g}")
    check(max(bias_err.values()) <= REC_BIAS_ROUNDING,
          f"the conv stem's bias gradient exceeds float32 rounding: {bias_err}")
    step_against_f64("recognizer", "train_vocal_tract,dropout=0,margins=0,B=2,T=32", out, exact,
                     zero={n for n in exact if re.fullmatch(r"residual\.\d+\.conv0\.bias", n)},
                     own={"conv.bias"})


def recognizer_loss_falls(cfg):
    """10 steps on one batch (B = 4, T = 128) with the config's dropout and
    logit margins, AdamW at lr 1e-3: the loss must fall."""
    st = state.create_train_state(rec_model(cfg, "cuda", seed=5), 1e-3, cfg["weight_decay"])
    batch = rec_batch(4, 128, cfg["model_params"]["num_features"],
                      len(load_vocabulary(cfg["vocab_filepath"])), seed=12, device="cuda",
                      ragged=False, n_labels=20)
    step = make_recognition_train_step("ctc", "ctc_target", feature="vocal_tract",
                                       logits_large_margins=cfg["logits_large_margins"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    losses = [step(st, batch, gen)["loss"].item() for _ in range(10)]
    phase("recognizer", fixed_batch_lr=1e-3, dropout=cfg["model_params"]["dropout"],
          loss_first=f"{losses[0]:.6g}", loss_last=f"{losses[-1]:.6g}",
          ratio=f"{losses[-1] / losses[0]:.4f}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"loss did not fall: {losses}")


# -- scoring synthesized corpora, and training through a frozen recognizer ------

def synthetic_batches(datadir, vocab_path, batch_size):
    """Batches RecognitionLoader makes of a synthesized corpus: its sentences
    (those with air columns) grouped by bucket of their frame counts."""
    dataset = SyntheticPhonemeRecognitionDataset(
        datadir, SyntheticPhonemeRecognitionDataset.sequences_from_corpus(datadir),
        load_vocabulary(vocab_path), ["vocal_tract"])
    per_bucket = {}
    for item in dataset.data:
        bucket = pick_bucket(len(item["frame_ids"]), REC_BUCKETS)
        per_bucket[bucket] = per_bucket.get(bucket, 0) + 1
    return dataset, sum(-(-n // batch_size) for n in per_bucket.values())


def synthetic_path(tmp, corpus, vocab_path):
    """(a) The recognizer's test CLI with ``synthetic: true`` over the seven
    test_synthetic_* configs, each datadir at the corpus an earlier phase
    synthesized (SYNTHESIS_DIRS) and state_dict_filepath at the best
    checkpoint of [recognizer]'s train_vocal_tract run (its _voicing run's
    for the _voicing configs): gru_fwd launches = layers x the corpus's test
    batches and nothing else, the artifacts, finite PER/WIL; then one
    synthetic batch, voiced, through the eval step on the card against the
    CPU. (b) The latent RNN's train CLI (train_autoencoder_based.yaml,
    num_epochs 1, [pc]'s AE checkpoints) with a ``recognizer:`` block
    (train_vocal_tract.yaml's model_params and best state) and beta4 0.5:
    exact launches, checkpoints, finite metrics, the recognizer counted in
    no parameter count. Returns the launches and wall seconds of each run."""
    none = dict.fromkeys(KERNELS, 0)
    results, launches, seconds = {}, {}, {}
    best = {v: os.path.join(tmp, f"rec_train_vocal_tract{v}", "checkpoints", "best", "state")
            for v in ("", "_voicing")}
    voiced = None
    for name in SYNTHETIC_TESTS:
        p = f"syn_{name}"
        original = config_file.load(os.path.join(REC_CONFIGS, f"{name}.yaml"))
        datadir = os.path.join(tmp, SYNTHESIS_DIRS[original["datadir"]])
        voicing = "voicing_filepath" in original
        changes = {"datadir": datadir, "vocab_filepath": vocab_path,
                   "state_dict_filepath": best["_voicing" if voicing else ""],
                   **({"voicing_filepath": REC_VOICING} if voicing else {})}
        path = os.path.join(tmp, f"{p}.yaml")
        cfg = thesis_config(name, path, changes, folder=REC_CONFIGS)
        check(cfg["synthetic"] is True, f"{name}: synthetic")
        dataset, test_batches = synthetic_batches(datadir, vocab_path, cfg["batch_size"])
        expected = {**none, "gru_fwd": cfg["model_params"]["num_rnn_layers"] * test_batches}
        reset_launch_counts()
        results[p], seconds[p] = run_cli(test_phoneme_recognition, path, os.path.join(tmp, p))
        launches[p] = launch_counts()
        phase("synthetic", cli=p, corpus=os.path.basename(datadir), sentences=len(dataset),
              frames=sum(len(d["frame_ids"]) for d in dataset.data), seconds=f"{seconds[p]:.3f}",
              **{f"{k}_launches": v for k, v in launches[p].items() if v or expected[k]},
              **{f"{k}_expected": v for k, v in expected.items() if v},
              loss=f"{results[p]['loss']:.6g}", per=f"{results[p]['edit_distance']:.6g}",
              wil=f"{results[p]['word_info_lost']:.6g}")
        check(launches[p] == expected, f"{p}: kernel launches {launches[p]}, expected {expected}")
        check(len(dataset) > 0, f"{p}: no synthesized sentence in {datadir}")
        check_rec_outputs(os.path.join(tmp, p), results[p], train=False)
        if voicing and voiced is None:
            voiced = (dataset, cfg, name)
    recognizer_eval_against_cpu(*voiced[:2], "synthetic", voiced[2])

    # (b) the latent RNN's train CLI with a frozen recognizer.
    p = "syn_pc_train_recognizer"
    rec_cfg = config_file.load(os.path.join(REC_CONFIGS, "train_vocal_tract.yaml"))
    ae_ckpts = os.path.join(tmp, "pc_train_ae", "checkpoints")
    path = os.path.join(tmp, f"{p}.yaml")
    cfg = thesis_config(
        "train_autoencoder_based", path,
        {"database_name": "gottingen", "datadir": corpus, "vocab_filepath": vocab_path,
         "num_epochs": 1, "beta4": FROZEN_BETA4,
         "encoder_state_dict_filepath": os.path.join(ae_ckpts, "best_encoder"),
         "decoder_state_dict_filepath": os.path.join(ae_ckpts, "best_decoder")},
        {"recognizer": {"state_dict_filepath": best[""], "model_params": rec_cfg["model_params"]}},
        folder=PC_CONFIGS)
    vocabulary, arts = load_vocabulary(vocab_path), sorted(cfg["indices_dict"])
    tr, va, te = (n_batches([len(d["frame_ids"]) for d in PrincipalComponentsDataset(
        corpus, "gottingen", sequences_from_dict(corpus, cfg[key]), vocabulary, arts,
        clip_tails=cfg["clip_tails"]).data], cfg["batch_size"])
        for key in ("train_seq_dict", "valid_seq_dict", "test_seq_dict"))
    # The latent RNN's 2 BiGRU launches a forward (2 backward a train step);
    # the recognizer's loss term runs it on the targets and on the outputs
    # in every train and valid step (one GRU launch a recurrent layer each)
    # and back through the outputs' in every train step; the test decodes
    # without the loss.
    layers = rec_cfg["model_params"]["num_rnn_layers"]
    expected = {**none, "gru_fwd": 2 * (tr + va + te) + 2 * layers * (tr + va),
                "gru_bwd": 2 * tr + layers * tr, "p2cp": va + te, "min_dist": 2 * te}
    reset_launch_counts()
    results[p], seconds[p] = run_cli(train_phoneme_to_principal_components, path,
                                     os.path.join(tmp, p))
    launches[p] = launch_counts()
    out = os.path.join(tmp, p)
    with open(os.path.join(out, "run", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    counts = {}
    for run in (p, "pc_train_ae_gru"):
        with open(os.path.join(tmp, run, "run", "params.json")) as f:
            counts[run] = json.load(f)["num_network_params"]
    phase("synthetic", cli=p, seconds=f"{seconds[p]:.3f}", train_batches=tr, valid_batches=va,
          test_batches=te, **{f"{k}_launches": v for k, v in launches[p].items() if v or expected[k]},
          **{f"{k}_expected": v for k, v in expected.items() if v},
          **fmt({k: v for k, v in records[-1].items() if k != "ts"}),
          p2cp_mm=f"{results[p]['p2cp_mm']:.6g}", num_network_params=counts[p],
          without_recognizer=counts["pc_train_ae_gru"])
    check(launches[p] == expected, f"{p}: kernel launches {launches[p]}, expected {expected}")
    check(len(records) == 1 and all(np.isfinite(v) for k, v in records[0].items() if k != "ts")
          and all(np.isfinite(v) for v in flat(results[p]).values()), f"{p}: non-finite metrics")
    for sub in ("checkpoints/best/state.pt", "checkpoints/last/state.pt", "checkpoints/best_model",
                "test_results.json"):
        check(os.path.isfile(os.path.join(out, sub)), f"{p} wrote no {sub}")
    check(counts[p] == counts["pc_train_ae_gru"], f"{p}: the recognizer counted in {counts}")
    return launches, seconds


def frozen_recognizer(cfg, device, dtype=None):
    """``cfg``'s DeepSpeech2 at full width (num_features = 10 articulators x
    50 points) with seeded weights, frozen: its recognizer_fn and module."""
    model = rec_model(cfg, device, seed=6)
    if dtype is not None:
        model = model.to(dtype)
    return frozen_recognizer_fn(model), model


def voiced_batch(batch, seed):
    """``batch`` with a seeded 0/1 voicing, -1 past each row's length (the
    loaders' padding)."""
    lengths = batch["lengths"].cpu().numpy()
    b, t = batch["tokens"].shape
    rng = np.random.default_rng(seed)
    pad = np.arange(t)[None, :] >= lengths[:, None]
    voicing = np.where(pad, np.float32(-1.0), rng.integers(0, 2, (b, t)).astype(np.float32))
    return {**batch, "voicing": torch.as_tensor(voicing, device=batch["tokens"].device)}


def frozen_steps_path(cfg):
    """(c) The thesis ArtSpeech train step (dropout 0.1) with train_vocal_tract's
    recognizer frozen in its loss, and the LSTM latent RNN's with it in the
    beta4 term, at B = 12, T = 128 on the card: exact launches (each
    recognizer pass a gru_fwd launch a recurrent layer, on the targets and
    on the outputs, and a gru_bwd one back through the outputs'), the
    recognizer's parameters untouched and outside the optimizer, step ms,
    frames/s and the device breakdown. Returns the launches of one step of
    each."""
    layers = cfg["model_params"]["num_rnn_layers"]
    total = dict.fromkeys(KERNELS, 0)
    rec_fn, rec = frozen_recognizer(cfg, "cuda")
    before = {n: p.detach().clone() for n, p in rec.named_parameters()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    latent_cfg, _ = latent_config()
    loss_fn, decode, mean, std = latent_loss("cuda", recognizer_fn=rec_fn, beta4=FROZEN_BETA4)
    runs = {
        "artspeech": (thesis_state(None), make_artspeech_train_step(TO_MM, recognizer_fn=rec_fn),
                      voiced_batch(fixed_batch(FROZEN_B, FROZEN_T, seed=14, device="cuda"), 14),
                      {"gru_fwd": 2 + 2 * layers, "gru_bwd": 2 + layers}),
        "latent_rnn": (state.create_train_state(latent_model("cuda"), latent_cfg["learning_rate"],
                                                latent_cfg["weight_decay"]),
                       make_latent_rnn_train_step(loss_fn, decode, mean, std, TO_MM,
                                                  latent_cfg["rescale_factor"]),
                       voiced_batch(pc_batch(FROZEN_B, FROZEN_T, seed=15, device="cuda"), 15),
                       {"lstm_fwd": 2, "lstm_bwd": 2, "gru_fwd": 2 * layers, "gru_bwd": layers}),
    }
    for name, (st, step, batch, counts) in runs.items():
        reset_launch_counts()
        loss = step(st, batch, gen)["loss"].item()
        got = launch_counts()
        expected = {**dict.fromkeys(KERNELS, 0), **counts}
        check(got == expected, f"{name} step with a frozen recognizer: launches {got}, "
                               f"expected {expected}")
        total = {k: total[k] + v for k, v in got.items()}
        frames = int(batch["lengths"].sum())
        step_ms, peak_gib = timed_step(step, st, batch, gen, f"{name}_frozen_recognizer_B{FROZEN_B}")
        phase("synthetic", step=name, recognizer="train_vocal_tract (frozen)", B=FROZEN_B,
              T=FROZEN_T, valid_frames=frames, loss=f"{loss:.6g}", step_ms=f"{step_ms:.6g}",
              frames_per_s=f"{frames / step_ms * 1e3:.6g}", peak_gib=f"{peak_gib:.3f}",
              **{f"{k}_launches": v for k, v in got.items() if v})
        check(np.isfinite(loss), f"{name} step with a frozen recognizer: loss {loss}")
        optimized = {id(p) for group in st.optimizer.param_groups for p in group["params"]}
        check(not optimized & {id(p) for p in rec.parameters()},
              f"{name}: the optimizer holds the recognizer's parameters")
    same = all(torch.equal(p, before[n]) and p.grad is None for n, p in rec.named_parameters())
    phase("synthetic", recognizer_parameters_unchanged=same)
    check(same, "a step moved or gave gradients to the frozen recognizer")
    return total


def frozen_step_against_f64(cfg):
    """(c) One ArtSpeech train step with the frozen recognizer (dropout 0, B =
    12, T = 128 ragged, voicing -1 past each row's length) on the card and on
    the CPU, the same seeded weights, held to float64 gradients on the CPU by
    step_against_f64; then 10 steps on one batch at lr 1e-3 on the card: the
    loss must fall."""
    batch = voiced_batch(fixed_batch(FROZEN_B, FROZEN_T, seed=16, device="cpu"), 16)
    out = {}
    for device in ("cuda", "cpu"):
        st = thesis_state(device, dropout=0.0)
        step = make_artspeech_train_step(TO_MM, device=device,
                                         recognizer_fn=frozen_recognizer(cfg, device)[0])
        metrics = step(st, {k: v.to(device) for k, v in batch.items()})
        out[device] = ({k: v.item() for k, v in metrics.items()},
                       {n: p.grad.cpu().double() for n, p in st.model.named_parameters()},
                       {n: p.detach().cpu() for n, p in st.model.named_parameters()})
    model = thesis_state("cpu", dropout=0.0).model.double().train()
    rec_fn = frozen_recognizer(cfg, "cpu", torch.float64)[0]
    targets, voicing = batch["targets"].double(), batch["voicing"].double()
    outputs = model(batch["tokens"], batch["lengths"])
    with torch.no_grad():
        tgt_feats = rec_fn(to_recognizer_layout(targets), voicing)
    loss = masked_euclidean_loss(outputs, targets, batch["lengths"]) + recognition_feature_loss(
        rec_fn(to_recognizer_layout(outputs), voicing), tgt_feats, batch["lengths"])
    loss.backward()
    step_against_f64("synthetic", f"artspeech+frozen_recognizer,dropout=0,B={FROZEN_B},"
                                  f"T={FROZEN_T}", out,
                     {n: p.grad for n, p in model.named_parameters()})

    st = thesis_state(None, lr=1e-3)
    step = make_artspeech_train_step(TO_MM, recognizer_fn=frozen_recognizer(cfg, "cuda")[0])
    batch = voiced_batch(fixed_batch(FROZEN_B, FROZEN_T, seed=17, device="cuda"), 17)
    gen = torch.Generator(device="cuda").manual_seed(0)
    losses = [step(st, batch, gen)["loss"].item() for _ in range(10)]
    phase("synthetic", step="artspeech+frozen_recognizer", fixed_batch_lr=1e-3,
          loss_first=f"{losses[0]:.6g}", loss_last=f"{losses[-1]:.6g}",
          ratio=f"{losses[-1] / losses[0]:.4f}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"loss did not fall: {losses}")


def frozen_gru_vs_plain():
    """(d) Both GRU kernels at the frozen recognizer's shape (FROZEN_GRU: T =
    128, B = 12, H = 64, one direction, f32), with the all-ones mask of a
    recognizer called without lengths and with rows of length T, 1 and 0:
    gru_fwd within F32_TOL, gru_bwd's dx_proj, dW_h and db_h within
    BWD_F32_TOL of max(|ref|, 1) of the plain versions."""
    t, b, h = FROZEN_GRU
    xp, wh, bh, ragged = recognizer_gru_inputs(t, b, h, torch.float32, seed=18)
    gy = torch.randn(t, b, h, generator=torch.Generator().manual_seed(19)).cuda()
    for label, mask in (("all_ones", torch.ones_like(ragged)), ("T,1,0,...", ragged)):
        ys = hopper_gru.gru_sequence(xp, wh, bh, mask)
        fwd_err = (ys - hopper_gru.gru_sequence_reference(xp, wh, bh, mask)).abs().max().item()
        got = hopper_gru.gru_backward(xp, wh[None], bh[None], mask, ys, gy, 0)
        ref = hopper_gru.gru_sequence_backward_reference(xp, wh, bh, mask, ys, gy)
        errs = {n: rel_err(a, r) for n, a, r in zip(("dx", "dW", "db"),
                                                   (got[0], got[1][0], got[2][0]), ref)}
        torch.cuda.synchronize()
        phase("synthetic", kernels="gru_fwd,gru_bwd", T=t, B=b, H=h, directions=1,
              dtype="float32", mask=label, fwd_max_abs_err=f"{fwd_err:.3g}", fwd_tol=F32_TOL,
              **{f"bwd_rel_err_{k}": f"{v:.3g}" for k, v in errs.items()}, bwd_tol=BWD_F32_TOL,
              fwd_C=geometry_fields(b, 1, h, 3, torch.float32)["C"],
              bwd_C=bwd_geometry_fields(b, 1, h, 3, torch.float32)["C"])
        check(np.isfinite(fwd_err) and fwd_err <= F32_TOL,
              f"gru_fwd at the frozen recognizer's shape ({label}): {fwd_err}")
        check(all(np.isfinite(v) and v <= BWD_F32_TOL for v in errs.values()),
              f"gru_bwd at the frozen recognizer's shape ({label}): {errs}")


# -- timing --------------------------------------------------------------------

SURFACE_TOL = 1e-5  # card against CPU: the report's CSV numbers, the air columns
SURFACE_GRAD = dict(b=12, t=128)  # the thesis test batch through the autograd path
SURFACE_GRAD_TOL = 1e-4  # gradients, relative to max(|ref|, 1)
SURFACE_PLOT_FRAMES = 10  # frames of the one-sentence corpus the generate CLI renders


def csv_numbers(path):
    """Every row of a CSV (its header rows too) with each field that parses
    as a number read as a float (an empty field stays text)."""
    head, rows = read_csv(path)

    def number(field):
        try:
            return float(field)
        except ValueError:
            return field

    return [[number(field) for field in row] for row in [head] + rows]


def same_csv(got, ref, rtol, name):
    """Two CSVs read by csv_numbers with the same text fields and numbers
    within ``rtol`` relative (NaN where NaN). Returns the largest relative
    difference."""
    check(len(got) == len(ref) and all(len(a) == len(b) for a, b in zip(got, ref)),
          f"{name}: the card's and the CPU's differ in shape")
    worst = 0.0
    for a_row, b_row in zip(got, ref):
        for a, b in zip(a_row, b_row):
            if isinstance(b, float) and isinstance(a, float):
                if np.isnan(a) and np.isnan(b):
                    continue
                diff = abs(a - b) / max(abs(b), np.finfo(np.float32).tiny)
                worst = max(worst, diff if a != b else 0.0)
            else:
                check(a == b, f"{name}: {a!r} on the card where the CPU has {b!r}")
    check(worst <= rtol, f"{name}: the card's numbers differ from the CPU's by {worst:.3g} "
                         f"relative")
    return worst


REPORT_CSVS = ("tract_variables.csv", "error_report_full.csv", "error_report_agg.csv",
               "TV_corr_report.csv")


def report_surface(tmp):
    """The report CLI over the [cli] test run's outputs, on the card and
    then on the CPU (each writes its CSVs into the run's directory; the
    card's are read before the CPU's overwrite them): one p2cp launch a
    sentence, the four CSVs within SURFACE_TOL. Returns the card run's
    launches."""
    results = os.path.join(tmp, "test_run")
    sentences = len(os.listdir(os.path.join(results, "test_outputs", "0")))
    runs, seconds, tables, launches = {}, {}, {}, None
    for device in ("cuda", "cpu"):
        cfg_path = os.path.join(tmp, f"report_{device}.yaml")
        thesis_config("report_model_free", cfg_path,
                      {"database_name": "gottingen", "results_dir": results},
                      None if device == "cuda" else {"make_plots": "false"})
        reset_launch_counts()
        runs[device], seconds[device] = run_cli(report_phoneme_to_articulation, cfg_path,
                                                os.path.join(tmp, f"report_{device}_run"),
                                                None if device == "cuda" else "cpu")
        if device == "cuda":
            launches = launch_counts()
        tables[device] = {name: csv_numbers(os.path.join(results, name)) for name in REPORT_CSVS}
    expected = {**dict.fromkeys(KERNELS, 0), "p2cp": sentences}
    check(launches == expected, f"report CLI: launches {launches}, expected {expected}")
    diffs = {name: same_csv(tables["cuda"][name], tables["cpu"][name], SURFACE_TOL, name)
             for name in REPORT_CSVS}
    errors = runs["cuda"]["errors"]
    check(len(errors.rows) > 0 and all(np.isfinite(r["p2cp_mm"]) for r in errors.rows),
          "report CLI: no finite P2CP")
    phase("surfaces", check="report", sentences=sentences, p2cp_launches=launches["p2cp"],
          error_rows=len(errors.rows), plots_skipped=runs["cuda"]["plots_skipped"],
          cuda_seconds=f"{seconds['cuda']:.3f}", cpu_seconds=f"{seconds['cpu']:.3f}",
          **{f"{n[:-4]}_max_rel_diff": f"{d:.3g}" for n, d in diffs.items()}, tol=SURFACE_TOL)
    return launches


def air_column_surface(corpus):
    """shape_to_air_column over one sequence of the corpus on the card and
    then on the CPU (the card's arrays read before the CPU's overwrite
    them): one (2, 2, 100) array a frame, within SURFACE_TOL."""
    subject, sequence = CLI_CORPUS["subject"], CLI_CORPUS["sequences"][-1]
    air_dir = os.path.join(corpus, subject, sequence, "air_column")
    cfg_path = os.path.join(os.path.dirname(corpus), "air_column.yaml")
    with open(cfg_path, "w") as f:
        f.write("\n".join([f"datadir: {corpus}", "database_name: gottingen", "seq_dict:",
                           f"  {subject}:", f"  - {sequence}", "batch_size: 64"]) + "\n")
    arrays, seconds = {}, {}
    for device in ("cuda", "cpu"):
        shutil.rmtree(air_dir, ignore_errors=True)  # [recognizer]'s seeded arrays, then the card's
        written, seconds[device] = run_cli(shape_to_air_column, cfg_path,
                                           os.path.join(os.path.dirname(corpus),
                                                        f"air_{device}_run"),
                                           None if device == "cuda" else "cpu")
        arrays[device] = {n: np.load(os.path.join(air_dir, n)) for n in sorted(os.listdir(air_dir))}
        check(written == len(arrays[device]), f"shape_to_air_column: {written} reported, "
                                              f"{len(arrays[device])} written")
    frames = len(DATABASE_COLLECTORS["gottingen"](corpus).get_frame_ids(subject, sequence))
    check(sorted(arrays["cuda"]) == sorted(arrays["cpu"]) and len(arrays["cuda"]) == frames,
          "shape_to_air_column: the card and the CPU wrote other files")
    diff = max(np.abs(arrays["cuda"][n] - arrays["cpu"][n]).max() for n in arrays["cpu"])
    shapes = {a.shape for a in arrays["cuda"].values()}
    check(shapes == {(2, 2, 100)} and diff <= SURFACE_TOL,
          f"shape_to_air_column: shapes {shapes}, card against CPU {diff}")
    phase("surfaces", check="shape_to_air_column", sequence=sequence, frames=frames,
          max_abs_diff=f"{diff:.3g}", tol=SURFACE_TOL, cuda_seconds=f"{seconds['cuda']:.3f}",
          cpu_seconds=f"{seconds['cpu']:.3f}")


def native_loader_surface(corpus):
    """The [cli] corpus's vocal-tract shapes through VocalTractShapeLoader
    with the native prefetch and without it (cache cleared between): the
    same arrays bit for bit, with both host times."""
    subject = CLI_CORPUS["subject"]
    collector = DATABASE_COLLECTORS["gottingen"](corpus)
    loader = loaders.VocalTractShapeLoader(corpus, sorted(RECOGNITION_ARTICULATORS), 50,
                                           DATASET_CONFIG["gottingen"])
    native_prefetch = loaders.prefetch_contours

    def load_all():
        loaders.clear_contour_cache()
        t0 = time.perf_counter()
        out = [loader.load_vocal_tract_shapes(subject, seq, collector.get_frame_ids(subject, seq))
               for seq in CLI_CORPUS["sequences"]]
        return out, time.perf_counter() - t0

    loaders.prefetch_contours(["warm.npy"], 1.0)  # build and load the library first
    primed = []
    loaders.prefetch_contours = lambda *a, **k: primed.append(native_prefetch(*a, **k))
    try:
        with_prefetch, native_s = load_all()
        loaders.prefetch_contours = lambda *a, **k: 0
        plain, plain_s = load_all()
    finally:
        loaders.prefetch_contours = native_prefetch
        loaders.clear_contour_cache()
    same = all(np.array_equal(a.view(np.uint32), b.view(np.uint32))
               for x, y in zip(with_prefetch, plain) for a, b in zip(x[:2], y[:2]))
    frames = sum(x[2] for x in plain)
    check(same and frames > 0 and sum(primed) > 0,
          f"native loader: bitwise {same}, {frames} frames, {sum(primed)} files primed")
    phase("surfaces", check="native_loader", frames=frames, files_primed=sum(primed),
          bitwise_equal=same, prefetch_host_s=f"{native_s:.4f}", plain_host_s=f"{plain_s:.4f}",
          speedup=f"{plain_s / native_s:.3g}")


def gradient_surface():
    """p2cp_distance_mm and the tract variables at B = 12, T = 128 through
    the kernels' autograd path against the plain route on the same card
    inputs: values within SURFACE_TOL, gradients within SURFACE_GRAD_TOL *
    max(|ref|, 1); one p2cp and one min_dist launch, none on the plain route.
    Returns the launches and the TVs' gradient."""
    b, t = SURFACE_GRAD["b"], SURFACE_GRAD["t"]
    arts = TV_STACK_ARTS
    g = torch.Generator().manual_seed(30)
    outputs = torch.rand(b, t, len(arts), 2, 50, generator=g).cuda()
    targets = torch.rand(b, t, len(arts), 2, 50, generator=g).cuda()
    lengths = torch.randint(1, t + 1, (b,), generator=g).cuda()
    lengths[0] = t
    cotangent = torch.randn(len(TV_SHAPES), b, t, 5, generator=g).cuda()

    def run():
        x = outputs.clone().requires_grad_()
        p2cp = articulation_losses.p2cp_distance_mm(x, targets, lengths, to_mm=TO_MM)
        (grad_p2cp,) = torch.autograd.grad(p2cp, (x,))
        tvs = tract_variables.tract_variables_from_stack(x, arts)
        stacked = torch.stack([torch.cat([tvs[n]["value"][..., None], tvs[n]["poc_1"],
                                          tvs[n]["poc_2"]], -1) for n in TV_SHAPES])
        (grad_tvs,) = torch.autograd.grad(stacked, (x,), cotangent)
        return p2cp.detach(), grad_p2cp, stacked.detach(), grad_tvs

    reset_launch_counts()
    kernel = run()
    torch.cuda.synchronize()
    launches = launch_counts()
    plain_p2cp, plain_windows = (articulation_losses.mean_p2cp_channel_major,
                                 tract_variables.min_distance_windows)
    articulation_losses.mean_p2cp_channel_major = hopper_p2cp.mean_p2cp_channel_major_reference
    tract_variables.min_distance_windows = hopper_min_dist.min_distance_windows_reference
    try:
        reset_launch_counts()
        plain = run()
        plain_launches = launch_counts()
    finally:
        articulation_losses.mean_p2cp_channel_major = plain_p2cp
        tract_variables.min_distance_windows = plain_windows
    expected = {**dict.fromkeys(KERNELS, 0), "p2cp": 1, "min_dist": 1}
    check(launches == expected and plain_launches == dict.fromkeys(KERNELS, 0),
          f"autograd path: launches {launches} (plain route {plain_launches}), expected {expected}")
    errs = {name: rel_err(got, ref) for name, got, ref in
            zip(("p2cp_value", "p2cp_grad", "tv_outputs", "tv_grad"), kernel, plain)}
    value_errs = {"p2cp_value": errs["p2cp_value"],
                  "tv_values": rel_err(kernel[2][..., 0], plain[2][..., 0])}
    same_places = bool(torch.equal(kernel[2][..., 1:], plain[2][..., 1:]))
    phase("surfaces", check="autograd", shape=f"B={b},T={t},arts={len(arts)}",
          p2cp_launches=launches["p2cp"], min_dist_launches=launches["min_dist"],
          same_places=same_places, **{k: f"{v:.3g}" for k, v in {**errs, **value_errs}.items()},
          value_tol=SURFACE_TOL, grad_tol=SURFACE_GRAD_TOL)
    check(max(value_errs.values()) <= SURFACE_TOL and same_places,
          f"autograd path values: {value_errs}, the same places: {same_places}")
    check(errs["p2cp_grad"] <= SURFACE_GRAD_TOL and errs["tv_grad"] <= SURFACE_GRAD_TOL,
          f"autograd path gradients: {errs}")
    return launches, kernel[3]


def sentence_layer_surface(tmp, corpus):
    """make_sentence_layer over the corpus's TextGrids."""
    grids = sorted(glob.glob(os.path.join(corpus, "*", "*", "*.textgrid")))
    cfg_path = os.path.join(tmp, "sentence_layer.yaml")
    save_to = os.path.join(tmp, "sentence_layers")
    with open(cfg_path, "w") as f:
        f.write(f"glob: {os.path.join(corpus, '*', '*', '*.textgrid')}\nsave_to: {save_to}\n")
    written, seconds = run_cli(make_sentence_layer, cfg_path, os.path.join(tmp, "sentence_run"))
    tiers = {tuple(read_textgrid(p).get_tier_names()) for p in written}
    check(len(written) == len(grids) > 0 and tiers == {("LongSentenceTier", "ShortSentenceTier",
                                                        "WordTier", "PhonTier")},
          f"make_sentence_layer: {len(written)} of {len(grids)} TextGrids, tiers {tiers}")
    phase("surfaces", check="make_sentence_layer", textgrids=len(written),
          seconds=f"{seconds:.3f}")


def optional_libraries_surface(tmp, vocab_path, best_state):
    """The generate CLI's save_plots and save_videos over a one-sentence
    corpus: one jpg a frame and one .avi where matplotlib (and cv2) import,
    else the RuntimeError naming what is missing."""
    present = {name: not missing_packages(name) for name in ("matplotlib", "cv2")}
    corpus = os.path.join(tmp, "plot_corpus")
    make_synthetic_corpus(corpus, subjects=(CLI_CORPUS["subject"],),
                          sequences=(CLI_CORPUS["sequences"][-1],), n_sentences=1,
                          frames_per_sentence=SURFACE_PLOT_FRAMES,
                          framerate=DATASET_CONFIG["gottingen"].FRAMERATE)
    outcome = {}
    for key, needs in (("save_plots", ("matplotlib",)), ("save_videos", ("cv2", "matplotlib"))):
        save_to = os.path.join(tmp, f"plot_{key}")
        cfg_path = os.path.join(tmp, f"{key}.yaml")
        thesis_config("generate_vocal_tract_shape_model_free", cfg_path,
                      {"database_name": "gottingen", "datadir": corpus,
                       "vocab_filepath": vocab_path, "state_dict_filepath": best_state,
                       "save_to": save_to}, {key: "true"})
        try:
            written, _ = run_cli(generate_vocal_tract_shape, cfg_path,
                                 os.path.join(tmp, f"{key}_run"))
        except RuntimeError as err:
            check(not all(present[n] for n in needs) and key in str(err),
                  f"{key}: {err} with {present}")
            outcome[key] = f"raised:{str(err).replace(' ', '_')}"
            continue
        check(all(present[n] for n in needs), f"{key} rendered without {needs}")
        for sentence in written:
            if key == "save_plots":
                jpgs = os.listdir(os.path.join(sentence, "vocal_tract_shapes"))
                with open(os.path.join(sentence, "target_sequence.txt")) as f:
                    frames = len(f.read().split())
                check(len(jpgs) == frames > 0, f"save_plots: {len(jpgs)} jpgs for {frames} frames")
            else:
                avi = os.path.join(sentence, os.path.basename(sentence) + ".avi")
                check(os.path.getsize(avi) > 0, f"save_videos wrote no {avi}")
        outcome[key] = "rendered"
    phase("surfaces", check="optional_libraries", **{f"{n}_present": p for n, p in present.items()},
          **outcome)


def surfaces_path(tmp, corpus, vocab_path, best_state):
    """[surfaces]: the report CLI, shape_to_air_column, the native loader,
    the distance kernels under autograd, make_sentence_layer and the
    optional plotting libraries, each timed by StepTimer. Returns the
    launches of the report CLI and of the autograd check."""
    timer = StepTimer()
    launches = {}
    with timer.step():
        launches["surfaces_report"] = report_surface(tmp)
    with timer.step():
        air_column_surface(corpus)
    with timer.step():
        native_loader_surface(corpus)
    with timer.step() as out:
        launches["surfaces_autograd"], out["result"] = gradient_surface()
    with timer.step():
        sentence_layer_surface(tmp, corpus)
    with timer.step():
        optional_libraries_surface(tmp, vocab_path, best_state)
    names = ("report", "air_column", "native_loader", "autograd", "sentence_layer",
             "optional_libraries")
    phase("surfaces", seconds=f"{sum(timer.times_ms) / 1e3:.3f}",
          **{f"{n}_s": f"{ms / 1e3:.3f}" for n, ms in zip(names, timer.times_ms)},
          **{f"step_{k}": (f"{v:.6g}" if isinstance(v, float) else v)
             for k, v in timer.summary().items()})
    return launches


def gru_bound_ms(t, b, h, n_dir, elem_bytes):
    """Least time for the forward's work: bytes moved once over HBM, FLOPs of
    the recurrent product over the f32 (non-tensor-core) peak; the larger."""
    gates = 3 * h
    bytes_moved = elem_bytes * (t * b * n_dir * gates + n_dir * h * gates + n_dir * gates
                                + t * b * n_dir * h) + 4 * t * b
    flops = n_dir * t * b * (2 * h * gates + 12 * h)
    by_bytes, by_ops = bytes_moved / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def gru_bwd_bound_ms(t, b, h, n_dir, elem_bytes):
    """Least time for the backward's work: x_proj, ys, g, mask, W_h, b_h read
    and dx_proj written once, dW_h and db_h written once in f32; three
    (B, H) x (H, 3H)-sized products a step and direction (recompute, dh, dW)
    plus ~32 elementwise operations per hidden unit, over the f32 peak."""
    gates = 3 * h
    bytes_moved = (elem_bytes * (2 * t * b * n_dir * gates + 2 * t * b * n_dir * h
                                 + n_dir * h * gates + n_dir * gates)
                   + 4 * t * b + 4 * n_dir * (h * gates + gates))
    flops = n_dir * t * b * (3 * 2 * h * gates + 32 * h)
    by_bytes, by_ops = bytes_moved / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def p2cp_bound_ms(rows, n, m):
    """u and v read and the means written once; per pair one squared
    distance (two subtractions, a multiply and an FMA, counted as 2) and
    its two minima, one for each direction: seven operations."""
    bytes_moved = 4 * rows * 2 * (n + m) + 4 * rows
    ops = rows * n * m * 7
    by_bytes, by_ops = bytes_moved / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def min_dist_bound_ms(rows, shapes):
    """u and v read once, the distance (f32) and the pair (two int64) written
    once; per point pair two subtractions, two multiplies, an add and a
    compare: six operations. ``shapes``: the (N, M) of each call."""
    bytes_moved = sum(4 * rows * 2 * (n + m) + rows * (4 + 8 + 8) for n, m in shapes)
    ops = sum(rows * n * m * 6 for n, m in shapes)
    by_bytes, by_ops = bytes_moved / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def flash_bound_ms(n_rows, g, elem_bytes):
    """K and V rows read once, q read and the output written once in f32;
    a multiply-add per element for the score and one for PV."""
    bytes_moved = 2 * n_rows * HD * g * elem_bytes + 2 * HD * g * 4
    ops = 4 * n_rows * HD * g
    by_bytes, by_ops = bytes_moved / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def train_attention_bound_ms(g, l, n_pairs, backward, hd=HD):
    """Least time for the work over the causal (q, k) pairs: the forward
    reads q, k, v and keep and writes the output and lse once, 4 hd
    operations a pair (score and PV); the backward's function reads q, k, v,
    keep and dO and writes dq, dk, dv once, 10 hd operations a pair (score,
    dP, dV, dQ, dK)."""
    pairs = g * l * (l + 1) // 2
    rows = 4 * g * l * hd
    keep = 4 * n_pairs * l * l
    bytes_moved = 7 * rows + keep if backward else 4 * rows + keep + 4 * g * l
    ops = (10 if backward else 4) * hd * pairs
    by_bytes, by_ops = bytes_moved / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def time_train_attention():
    """Both kernels at the B = 12 and B = 64 shapes (G = 4,320 and 23,040,
    L = 128, hd 16, the dropout keep with 90 pairs; each call moves 100 MB or
    more, past the 50 MB L2; the resident kernels), on the streamed route at
    the long-bucket step's B = LONG_B (G = 720) at each L of
    TRAIN_ATTN_LONG_L, and at B = 12, L = 128 with the head dims of
    TRAIN_ATTN_TIMED_HD: by graph_ms (device time without host gaps), back to
    back and by profiler device time, the share of the bound (bound /
    graph_ms), their plain versions, the bound, and
    scaled_dot_product_attention on (G, 1, L, hd) with is_causal and an
    all-ones keep (forward, and forward + backward minus forward) as the
    yardstick. Returns {(kernel, B, L, hd): numbers}."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results = {}
    shapes = ([(b, TRAIN_T, HD) for b in TRAIN_BATCHES]
              + [(LONG_B, l, HD) for l in TRAIN_ATTN_LONG_L]
              + [(TRAIN["batch"], TRAIN_T, hd) for hd in TRAIN_ATTN_TIMED_HD])
    for b, l, hd in shapes:
        g = b * TRAIN_ATTN_G[1]
        q, k, v, keep, do = train_attention_inputs(g, l, TRAIN_ATTN_PAIRS, seed=b + l + hd - HD,
                                                   hd=hd)
        out, lse = hopper_train_attention.fused_causal_attend_fwd(q, k, v, keep, TRAIN_ATTN_PAIRS)
        sq, sk, sv = (x[:, None] for x in (q, k, v))
        gq, gk, gv = (x.clone().requires_grad_() for x in (sq, sk, sv))
        ones = torch.ones(1, l, l, device="cuda")
        lib_diff = (sdpa(sq, sk, sv, is_causal=True, scale=1.0)[:, 0]
                    - hopper_train_attention.fused_causal_attend_fwd(q, k, v, ones, 1)[0]
                    ).abs().max().item()

        def fwd():
            return hopper_train_attention.fused_causal_attend_fwd(q, k, v, keep, TRAIN_ATTN_PAIRS)

        def bwd():
            return hopper_train_attention.fused_causal_attend_bwd(q, k, v, keep, out, lse, do,
                                                                  TRAIN_ATTN_PAIRS)

        def lib_fwd():
            return sdpa(sq, sk, sv, is_causal=True, scale=1.0)

        def lib_both():
            sdpa(gq, gk, gv, is_causal=True, scale=1.0).backward(do[:, None])

        lib_fwd_ms = cuda_ms(lib_fwd, 20)
        for name, fn, plain, backward in (
                ("train_attention_fwd", fwd, lambda: hopper_train_attention.fused_causal_attend_reference(
                    q, k, v, keep, TRAIN_ATTN_PAIRS), False),
                ("train_attention_bwd", bwd, lambda: hopper_train_attention.fused_causal_attend_bwd_reference(
                    q, k, v, keep, do, TRAIN_ATTN_PAIRS), True)):
            bound_ms, bound_by = train_attention_bound_ms(g, l, TRAIN_ATTN_PAIRS, backward, hd)
            graph = graph_ms(fn, 10)
            traced = (f"{name}_kernel" if hopper_train_attention.resident(l, hd)
                      else ("train_attention_dq_stream_kernel", "train_attention_dkv_stream_kernel")
                      if backward else "train_attention_fwd_stream_kernel")
            results[(name, b, l, hd)] = dict(
                graph_ms=graph, share_of_bound=bound_ms / graph,
                ms=cuda_ms(fn, 20), device_ms=kernel_device_ms(fn, 10, traced),
                plain_ms=cuda_ms(plain, 3), bound_ms=bound_ms, bound_by=bound_by,
                library_ms=cuda_ms(lib_both, 10) - lib_fwd_ms if backward else lib_fwd_ms)
            geometry = train_attention_geometry_text(g, l, hd, TRAIN_ATTN_PAIRS)
            phase("timing", kernel=name, B=b, G=g, L=l, hd=hd, n_pairs=TRAIN_ATTN_PAIRS,
                  dtype="float32", library_max_abs_diff_fwd_ones=f"{lib_diff:.3g}",
                  geometry=geometry["bwd_geometry" if backward else "fwd_geometry"],
                  **fmt(results[(name, b, l, hd)]))
        del q, k, v, keep, do, out, lse, sq, sk, sv, gq, gk, gv
    return results


def kernel_device_ms(fn, calls, name):
    """Mean device ms per call of the kernels whose name holds ``name`` (or
    one of the names of a tuple), from a torch.profiler trace of host and
    device of ``calls`` calls of ``fn``; traced again, up to three times in
    all, while the trace holds fewer than ``calls`` launches of some name
    (deep into a long run, traces have come back short of launches), None
    if none holds them all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = (name,) if isinstance(name, str) else name
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if all(sum(e.count for e in kernels if n in e.key) >= calls for n in names):
            return sum(e.self_device_time_total for e in kernels
                       if any(n in e.key for n in names)) / 1e3 / calls
    return None


def graph_ms(fn, calls, replays=5):
    """Device ms a call of ``fn``: ``calls`` calls captured in one CUDA graph
    after a warm-up call, the graph replayed ``replays`` times between CUDA
    events. No host gaps between launches and no profiler; a refused capture
    raises."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * calls)


def host_us(fn, calls):
    """Host-clock microseconds a call spends enqueueing ``fn`` (the wrapper's
    checks, allocation and launch), the device's work not waited for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def flash_cache_sets(b, dtype):
    """Seeded copies of the self and cross-channel caches at batch b, as many
    as make FLASH_STREAM_BYTES together (at least 2), each with its query;
    and the same data laid out for scaled_dot_product_attention, (G, 1, 1,
    hd) x (G, 1, S, hd), permuted here, before any timed region."""
    groups = flash_groups(b)
    elem = torch.finfo(dtype).bits // 8
    copies = max(2, -(-FLASH_STREAM_BYTES // sum(2 * DECODE_T * HD * g * elem
                                                  for g in groups.values())))
    sets, sdpa_sets = {}, {}
    for kind, g in groups.items():
        sets[kind] = [flash_inputs(g, dtype, seed=g + i) for i in range(copies)]
        sdpa_sets[kind] = [(q.T.reshape(g, 1, 1, HD).to(dtype).contiguous(),
                            k.permute(2, 0, 1)[:, None].contiguous(),
                            v.permute(2, 0, 1)[:, None].contiguous()) for k, v, q in sets[kind]]
    return copies, sets, sdpa_sets


def flash_timings(calls_of, repeat, launches=1):
    """One reading: the kernel and SDPA over the same calls, each by
    graph_ms and back to back (cuda_ms), ``repeat`` calls of the function
    that ``calls_of("kernel")`` or ``calls_of("library")`` gives (each makes
    ``launches`` launches), and the wrapper's host us a launch."""
    kernel, library = calls_of("kernel"), calls_of("library")
    return dict(graph_ms=graph_ms(kernel, repeat), ms=cuda_ms(kernel, repeat),
                library_graph_ms=graph_ms(library, repeat), library_ms=cuda_ms(library, repeat),
                host_us=host_us(kernel, repeat) / launches)


def time_flash_decode():
    """flash_decode at the decode's own calls: the self (G = B*C*H) and
    cross-channel (B*C*(C-1)*H) caches at B = 12 and 64, f32 and bf16
    caches (and f16 at B = 12), n_rows in FLASH_TIMED_ROWS, each call on another of the cache
    copies of flash_cache_sets (they overflow the 50 MB L2, as the decode's
    8 caches a layer do); and a decode sweep, the 256 calls one layer makes
    over T = 128 (self, then cross-channel, at n_rows = t + 1), in ms a
    sweep. Each reading by graph_ms (device time, no host gaps) and back to
    back, beside scaled_dot_product_attention over the same calls measured
    the same way, the bound summed over the calls, the wrapper's host us a
    call and the launch geometry; the plain version and the profiler's device
    ms at the cross-channel n_rows = 128 call. Returns {(B, dtype, attend,
    n_rows): numbers} and {(B, dtype, "sweep"): numbers}."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results = {}
    for b in DECODE_BATCHES:
        groups = flash_groups(b)
        for dtype in (torch.float32, *HALF_DTYPES)[:3 if b == DECODE_BATCHES[0] else 2]:
            elem = torch.finfo(dtype).bits // 8
            dname = str(dtype).split(".")[-1]
            copies, sets, sdpa_sets = flash_cache_sets(b, dtype)
            k, v, q = sets["inter"][0]
            qs, ks, vs = sdpa_sets["inter"][0]
            lib_diff = (sdpa(qs, ks, vs, scale=1.0).float().reshape(-1, HD).T
                        - hopper_attention.flash_decode_attend(k, v, q, DECODE_T)).abs().max().item()
            # f16 caches: the sweep only (their single calls read as bf16's;
            # cut for the script's time limit).
            for kind, g in groups.items() if dtype != torch.float16 else ():
                for n_rows in FLASH_TIMED_ROWS:
                    def calls_of(which, kind=kind, n_rows=n_rows):
                        if which == "kernel":
                            cycle = itertools.cycle(sets[kind])
                            return lambda: hopper_attention.flash_decode_attend(*next(cycle), n_rows)
                        cycle = itertools.cycle(sdpa_sets[kind])

                        def library():
                            qq, kk, vv = next(cycle)
                            return sdpa(qq, kk[:, :, :n_rows], vv[:, :, :n_rows], scale=1.0)
                        return library

                    full = kind == "inter" and n_rows == DECODE_T
                    r = flash_timings(calls_of, copies * -(-24 // copies))
                    r["bound_ms"], r["bound_by"] = flash_bound_ms(n_rows, g, elem)
                    r["share_of_bound"] = r["bound_ms"] / r["graph_ms"]
                    if full:
                        cycle = itertools.cycle(sets[kind])
                        r["plain_ms"] = cuda_ms(lambda: hopper_attention.flash_decode_attend_reference(
                            *next(cycle), n_rows), 3)
                        r["device_ms"] = kernel_device_ms(calls_of("kernel"), 50, "flash_decode")
                    results[(b, dtype, kind, n_rows)] = r
                    phase("timing", kernel="flash_decode", B=b, attend=kind, G=g, hd=HD,
                          n_rows=n_rows, dtype=dname, cache_copies=copies,
                          **flash_geometry_fields(g, n_rows, dtype), **fmt(r),
                          **({"library_max_abs_diff": f"{lib_diff:.3g}"} if full else {}))

            sweep_calls = [(kind, t + 1) for t in range(DECODE_T) for kind in ("self", "inter")]

            def sweep_of(which):
                cycles = {kind: itertools.cycle(sets[kind] if which == "kernel" else sdpa_sets[kind])
                          for kind in groups}

                def sweep():
                    for kind, n_rows in sweep_calls:
                        if which == "kernel":
                            hopper_attention.flash_decode_attend(*next(cycles[kind]), n_rows)
                        else:
                            qq, kk, vv = next(cycles[kind])
                            sdpa(qq, kk[:, :, :n_rows], vv[:, :, :n_rows], scale=1.0)
                return sweep

            r = flash_timings(sweep_of, 3, len(sweep_calls))
            r["bound_ms"] = sum(flash_bound_ms(n, groups[kind], elem)[0] for kind, n in sweep_calls)
            r["share_of_bound"] = r["bound_ms"] / r["graph_ms"]
            results[(b, dtype, "sweep")] = r
            phase("timing", kernel="flash_decode", B=b, attend="sweep", calls=len(sweep_calls),
                  G=",".join(str(g) for g in groups.values()), hd=HD, n_rows=f"1..{DECODE_T}",
                  dtype=dname, cache_copies=copies, unit="ms_a_sweep", **fmt(r))
            del sets, sdpa_sets
    return results


def device_breakdown(run_once, step_ms, tag, steps=3, host_ops=True):
    """Where a step's time goes on the card: kernel launches and device-busy
    ms per step from a torch.profiler trace, the device's idle share against
    the untraced step time, and the top kernels. ``host_ops=False`` traces the
    device only (the decode's ~90k host ops a batch make a CPU trace slow to
    collect; the kernel figures are the same). Returns the (kernel, ms a
    step, calls a step) of the trace, None without device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] * host_ops + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        for _ in range(steps):
            run_once()
        torch.cuda.synchronize()
    # User annotations (Optimizer.step#AdamW.step) span kernels already counted.
    kernels = [(e.key, e.self_device_time_total / 1e3 / steps, e.count / steps)
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(ms for _, ms, _ in kernels)
    if busy_ms <= 0:
        phase("profile", step=tag, device_trace="no device time recorded")
        return
    launches = sum(n for _, _, n in kernels)
    phase("profile", step=tag, kernel_launches_per_step=f"{launches:.0f}",
          device_busy_ms_per_step=f"{busy_ms:.6g}", step_ms=f"{step_ms:.6g}",
          device_idle_share=f"{max(0.0, 1.0 - busy_ms / step_ms):.4f}")
    ranked = sorted(kernels, key=lambda k: -k[1])
    # The top six, then the port's own kernels further down.
    own = [k for k in ranked[6:] if any(f"{name}_kernel" in k[0] for name in KERNELS)]
    for name, ms, n in ranked[:6] + own:
        phase("profile", step=tag, kernel=name[:60].replace(" ", "_"), ms_per_step=f"{ms:.6g}",
              calls_per_step=f"{n:.0f}", share_of_busy=f"{ms / busy_ms:.3f}")
    return kernels


def host_ms(fn, iters):
    """Mean host-clock ms per call of work that ends in a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def time_gru_fwd():
    """The forward kernel at T = 128, H = 128, both directions, f32, at
    GRU_FWD_TIMED_B, beside its plain version, cuDNN's bidirectional
    nn.GRU forward and the bound, with its launch geometry and microseconds
    a step. Returns {(T, B): numbers}."""
    results = {}
    t, h = BENCH_T, HIDDEN
    for b in GRU_FWD_TIMED_B:
        xp, wh, bh, mask = gru_inputs(t, b, h, 2, torch.float32, seed=1)
        kernel_ms = cuda_ms(lambda: hopper_gru.bigru_sequence(xp, wh, bh, mask), 20)
        plain_ms = cuda_ms(lambda: bigru_reference(xp, wh, bh, mask), 3)
        cudnn = torch.nn.GRU(h, h, bidirectional=True).cuda()
        x = torch.randn(t, b, h, device="cuda")
        with torch.inference_mode():
            library_ms = cuda_ms(lambda: cudnn(x), 20)
        bound_ms, bound_by = gru_bound_ms(t, b, h, 2, 4)
        results[(t, b)] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, library_ms=library_ms,
                               us_per_step=kernel_ms * 1e3 / t,
                               geometry=geometry_fields(b, 2, h, 3, torch.float32))
        phase("timing", kernel="gru_fwd", T=t, B=b, H=h, directions=2, dtype="float32",
              **fmt({k: v for k, v in results[(t, b)].items() if k != "geometry"}),
              **results[(t, b)]["geometry"])
    return results


def time_half_gru():
    """Both GRU kernels at the test step's shape (T = 128, B = 12, H = 128,
    both directions) in each storage type, f32, bf16 and f16, by graph_ms
    (device time a call without host gaps) beside the bound at that
    element size: the f16 instances beside the bf16 ones they mirror.
    Returns {(kernel, dtype name): numbers}."""
    results = {}
    t, b, h = BENCH_T, GRU_FWD_TIMED_B[0], HIDDEN
    for dtype in (torch.float32, *HALF_DTYPES):
        xp, wh, bh, mask = gru_inputs(t, b, h, 2, dtype, seed=5)
        gy = torch.randn(t, b, 2 * h, generator=torch.Generator().manual_seed(6)).to(dtype).cuda()
        ys = hopper_gru.bigru_sequence(xp, wh, bh, mask)
        elem, name = xp.element_size(), str(dtype).split(".")[-1]
        for kernel, fn, bound in (
                ("gru_fwd", lambda: hopper_gru.bigru_sequence(xp, wh, bh, mask), gru_bound_ms),
                ("gru_bwd", lambda: hopper_gru.gru_backward(xp, wh, bh, mask, ys, gy, 0b10),
                 gru_bwd_bound_ms)):
            graph = graph_ms(fn, 10)
            bound_ms, bound_by = bound(t, b, h, 2, elem)
            results[(kernel, name)] = dict(graph_ms=graph, bound_ms=bound_ms, bound_by=bound_by,
                                           share_of_bound=bound_ms / graph)
            phase("timing", kernel=kernel, T=t, B=b, H=h, directions=2, dtype=name,
                  **fmt(results[(kernel, name)]))
    return results


def cudnn_bwd_ms(rnn, t, b, h, iters=25, bidirectional=True):
    """cuDNN's backward alone, the backward kernels' yardstick: ``rnn``
    (nn.GRU or nn.LSTM, bidirectional unless asked, f32, full-length rows) run forward
    once with its graph kept, then only torch.autograd.grad of its output by
    the input and every parameter (which also gives the input projection's
    gradients, left outside the port's kernels), timed with CUDA events:
    the median of ``iters`` runs after two warm-up runs. Returns (ms, device
    ms a call of every kernel in a profiler trace of it)."""
    cudnn = rnn(h, h, bidirectional=bidirectional).cuda()
    x = torch.randn(t, b, h, device="cuda", requires_grad=True)
    gy = torch.randn(t, b, (1 + bidirectional) * h, device="cuda")
    out = cudnn(x)[0]
    inputs = (x, *cudnn.parameters())

    def grad():
        return torch.autograd.grad(out, inputs, gy, retain_graph=True)

    for _ in range(2):
        grad()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        grad()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), kernel_device_ms(grad, 10, "")


def split_device_ms(fn, main):
    """Device ms a call of a backward's main kernel (names holding ``main``)
    and of its partial-sum kernel, and their sum (None where a trace held
    no device time)."""
    main_ms = kernel_device_ms(fn, 10, main)
    sum_ms = kernel_device_ms(fn, 10, "sum_partials")
    both = None if main_ms is None or sum_ms is None else main_ms + sum_ms
    return dict(device_ms=both, main_device_ms=main_ms, partial_sum_device_ms=sum_ms)


def time_gru_bwd():
    """The backward kernel at T = 128, H = 128, both directions, f32, at
    GRU_BWD_TIMED_B: back to back and by profiler device time (the main
    kernel and the partial-sum kernel apart), beside its plain version, the
    bound and cuDNN nn.GRU's backward timed alone (cudnn_bwd_ms), with its
    launch geometry and microseconds a step. Returns {B: numbers}."""
    results = {}
    t, h = BENCH_T, HIDDEN
    for b in GRU_BWD_TIMED_B:
        xp, wh, bh, mask = gru_inputs(t, b, h, 2, torch.float32, seed=3)
        gy = torch.randn(t, b, 2 * h, device="cuda")
        ys = hopper_gru.bigru_sequence(xp, wh, bh, mask)

        def bwd():
            return hopper_gru.gru_backward(xp, wh, bh, mask, ys, gy, 0b10)

        kernel_ms = cuda_ms(bwd, 20)
        plain_ms = cuda_ms(lambda: bigru_backward_reference(xp, wh, bh, mask, ys, gy), 3)
        library_ms, library_device_ms = cudnn_bwd_ms(torch.nn.GRU, t, b, h)
        bound_ms, bound_by = gru_bwd_bound_ms(t, b, h, 2, 4)
        results[b] = dict(ms=kernel_ms, **split_device_ms(bwd, "gru_bwd"), plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                          library_device_ms=library_device_ms, us_per_step=kernel_ms * 1e3 / t,
                          geometry=bwd_geometry_fields(b, 2, h, 3, torch.float32))
        phase("timing", kernel="gru_bwd", T=t, B=b, H=h, directions=2, dtype="float32",
              **fmt({k: v for k, v in results[b].items() if k != "geometry"}),
              **results[b]["geometry"])
    return results


def time_recognizer_gru(shape, label):
    """Both GRU kernels at a recognizer's (T, B, H) = ``shape``, one
    direction, f32, every row full (the recognizer's own T = 512, B = 4, H =
    64; inside the train steps' frozen recognizer, T = 128, B = 12): by
    graph_ms and back to back, the backward also by profiler device time
    (main and partial-sum kernels apart), beside the plain versions, the
    bounds and cuDNN's one-direction nn.GRU (its inference forward back to
    back and by profiler device time; its backward alone, cudnn_bwd_ms), with
    the launch geometry and microseconds a step. Returns {kernel: numbers}."""
    t, b, h = shape
    xp, wh, bh, _ = recognizer_gru_inputs(t, b, h, torch.float32, seed=5)
    mask = torch.ones(t, b, dtype=torch.bool, device="cuda")
    ys = hopper_gru.gru_sequence(xp, wh, bh, mask)
    gy = torch.randn(t, b, h, device="cuda")

    def fwd():
        return hopper_gru.gru_sequence(xp, wh, bh, mask)

    def bwd():
        return hopper_gru.gru_backward(xp, wh[None], bh[None], mask, ys, gy, 0)

    cudnn = torch.nn.GRU(h, h).cuda()
    x = torch.randn(t, b, h, device="cuda")

    def cudnn_fwd():
        with torch.inference_mode():
            return cudnn(x)

    cudnn_bwd, cudnn_bwd_device = cudnn_bwd_ms(torch.nn.GRU, t, b, h, bidirectional=False)
    results = {}
    fwd_graph = graph_ms(fwd, 20)
    results["gru_fwd"] = dict(
        ms=cuda_ms(fwd, 20), graph_ms=fwd_graph,
        plain_ms=cuda_ms(lambda: hopper_gru.gru_sequence_reference(xp, wh, bh, mask), 3),
        **dict(zip(("bound_ms", "bound_by"), gru_bound_ms(t, b, h, 1, 4))),
        library_ms=cuda_ms(cudnn_fwd, 20), library_device_ms=kernel_device_ms(cudnn_fwd, 10, ""),
        us_per_step=fwd_graph * 1e3 / t, geometry=geometry_fields(b, 1, h, 3, torch.float32))
    bwd_graph = graph_ms(bwd, 20)
    results["gru_bwd"] = dict(
        ms=cuda_ms(bwd, 20), graph_ms=bwd_graph, **split_device_ms(bwd, "gru_bwd"),
        plain_ms=cuda_ms(lambda: hopper_gru.gru_sequence_backward_reference(
            xp, wh, bh, mask, ys, gy), 3),
        **dict(zip(("bound_ms", "bound_by"), gru_bwd_bound_ms(t, b, h, 1, 4))),
        library_ms=cudnn_bwd, library_device_ms=cudnn_bwd_device,
        us_per_step=bwd_graph * 1e3 / t, geometry=bwd_geometry_fields(b, 1, h, 3, torch.float32))
    for name, numbers in results.items():
        phase("timing", kernel=name, T=t, B=b, H=h, directions=1, dtype="float32",
              shape=label, **fmt({k: v for k, v in numbers.items() if k != "geometry"}),
              **numbers["geometry"])
    return results


def time_recognizer_steps():
    """The recognizer's train step at full width, as the train CLI runs it
    (AdamW under the cyclic schedule, the configs' dropout 0.1 and logit
    margins 5e-4, 31 classes): train_acoustic's melspec model on B = 4 rows
    of 5.1 s of 16 kHz audio (319 frames in the 512 bucket, 60 labels) and
    train_vocal_tract's on B = 4 vocal-tract features (2, 500, 256), 40
    labels. Step ms (3 steps), frames/s and the device breakdown of one step
    (CUDA only: the CTC loop's ~40k host ops make a CPU trace slow); then the
    CTC loss alone (its forward and backward on the step's log-prob shape)
    the same way."""
    for name, feature in (("train_acoustic", "melspec"), ("train_vocal_tract", "vocal_tract")):
        cfg = config_file.load(os.path.join(REC_CONFIGS, f"{name}.yaml"))
        model = DeepSpeech2(num_classes=31, **model_kwargs_from_cfg(cfg, "model_params"),
                            generator=torch.Generator().manual_seed(6))
        st = state.create_train_state(model, cfg["learning_rate"], cfg["weight_decay"])
        g = torch.Generator().manual_seed(7)
        b = REC_PROFILE_B
        if feature == "melspec":
            samples = int(REC_AUDIO_S * 16000)
            frames = samples // 256 + 1
            t = pick_bucket(frames, REC_BUCKETS)
            audio = torch.zeros(b, (t - 1) * 256)
            audio[:, :samples] = 0.1 * torch.randn(b, samples, generator=g)
            batch = {"audio": audio, "input_lengths": torch.full((b,), frames, dtype=torch.int32)}
            n_labels = 60
        else:
            t = frames = REC_VT_T
            batch = {"features": torch.rand(b, 2, cfg["model_params"]["num_features"], t,
                                            generator=g),
                     "input_lengths": torch.full((b,), t, dtype=torch.int32)}
            n_labels = 40
        batch["voicing"] = torch.zeros(b, t)
        batch["ctc_target"] = torch.randint(2, 31, (b, n_labels), generator=g, dtype=torch.int32)
        batch["ctc_target_lengths"] = torch.full((b,), n_labels, dtype=torch.int32)
        batch = {k: v.cuda() for k, v in batch.items()}
        lr = cfg["learning_rate"]
        step = make_recognition_train_step(
            "ctc", "ctc_target", feature=feature,
            logits_large_margins=cfg["logits_large_margins"],
            schedule=cyclic_triangular_schedule(lr / 25, lr))
        gen = torch.Generator(device="cuda").manual_seed(0)
        tag = f"recognizer_{feature}_B{b}_T{t}"
        step_ms, peak_gib = timed_step(step, st, batch, gen, tag, iters=3, breakdown=False)
        phase("timing", recognizer_step=name, step_ms=f"{step_ms:.6g}",
              frames_per_s=f"{b * frames / step_ms * 1e3:.6g}", peak_gib=f"{peak_gib:.3g}",
              shape=f"B={b},T={t},valid_frames={frames},labels={n_labels}")
        device_breakdown(lambda: step(st, batch, gen), step_ms, tag, steps=1, host_ops=False)
        log_probs = torch.randn(b, t, 31, device="cuda").log_softmax(-1).requires_grad_()

        def ctc_once():
            loss = ctc_loss(log_probs, batch["ctc_target"], batch["input_lengths"],
                            batch["ctc_target_lengths"])
            loss.backward()

        ctc_ms = host_ms(ctc_once, 2)
        phase("timing", recognizer_ctc=name, ctc_fwd_bwd_ms=f"{ctc_ms:.6g}",
              share_of_step=f"{ctc_ms / step_ms:.3f}", shape=f"B={b},T={t},K=31,N={n_labels}")
        device_breakdown(ctc_once, ctc_ms, f"{tag}_ctc_alone", steps=1, host_ops=False)


def shifted_conv(x, kernel, bias):
    """The K x K SAME convolution of (B, I, T, D) as the JAX package computes
    it: K * K shifted float32 products summed, with no patch tensor."""
    k = kernel.shape[0]
    t, d = x.shape[2:]
    xp = torch.nn.functional.pad(x, (k // 2,) * 4)
    out = bias[:, None, None]
    for i in range(k):
        for j in range(k):
            out = out + torch.einsum("bitd,io->botd", xp[:, :, i:i + t, j:j + d], kernel[i, j])
    return out


def time_recognizer_conv():
    """The recognizer's convolutions at the melspec step's shape (B = 4,
    T = 512, D = 80, 32 channels; the stem from 2 channels and a residual
    conv), forward and backward in float32 with TF32 off, as the port's
    entry points set it: the port's Conv (one product over the unfolded
    patches) against the K * K shifted products and against cuDNN's
    F.conv2d, with the memory each keeps past its inputs at its peak and
    each one's distance from the float64 sums (output and the three
    gradients); the port's within 1e-4 of the largest value."""
    resolve_device()
    b, t, d, c = REC_PROFILE_B, 512, 80, 32
    g = torch.Generator().manual_seed(8)
    for name, i in (("stem", 2), ("residual", c)):
        conv = Conv(i, c, generator=g).cuda()
        with torch.no_grad():
            conv.bias.normal_(generator=torch.Generator(device="cuda").manual_seed(9))
        x = torch.randn(b, i, t, d, generator=g).cuda().requires_grad_()
        gy = torch.randn(b, c, t, d, generator=g).cuda()
        params = (x, conv.kernel, conv.bias)
        exact_params = tuple(p.detach().double().requires_grad_() for p in params)
        y = shifted_conv(*exact_params)
        exact = (y.detach(), *torch.autograd.grad(y, exact_params, gy.double()))
        del y
        variants = {
            "unfold": lambda: conv(x),
            "shifted": lambda: shifted_conv(x, conv.kernel, conv.bias),
            "conv2d": lambda: torch.nn.functional.conv2d(
                x, conv.kernel.permute(3, 2, 0, 1), conv.bias, padding=1)}
        fields = {}
        for v, fn in variants.items():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            y = fn()
            got = (y.detach(), *torch.autograd.grad(y, params, gy))
            fields[f"{v}_extra_mib"] = f"{(torch.cuda.max_memory_allocated() - base) / 2**20:.1f}"
            del y
            err = max(rel_err(a, r) for a, r in zip(got, exact))
            fields[f"{v}_vs_f64"] = f"{err:.3g}"
            if v == "unfold":
                check(err <= REC_TOL, f"recognizer conv {name}: {err:.3g} from float64")
            fields[f"{v}_fwd_ms"] = f"{cuda_ms(fn, 10):.6g}"
            fields[f"{v}_fwd_bwd_ms"] = f"{cuda_ms(lambda: torch.autograd.grad(fn(), params, gy), 10):.6g}"
        phase("timing", recognizer_conv=name, shape=f"B={b},I={i},O={c},T={t},D={d},K=3,float32",
              **fields)

def lstm_bound_ms(t, b, h, n_dir, elem_bytes):
    """Least time for the forward's work: x_proj, W_h, b_h and the mask read
    and ys written once; the recurrent product plus ~16 elementwise
    operations per hidden unit (four activations, the cell, its tanh, the
    masked carries) over the f32 peak."""
    gates = 4 * h
    bytes_moved = elem_bytes * (t * b * n_dir * gates + n_dir * h * gates + n_dir * gates
                                + t * b * n_dir * h) + 4 * t * b
    flops = n_dir * t * b * (2 * h * gates + 16 * h)
    by_bytes, by_ops = bytes_moved / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def lstm_bwd_bound_ms(t, b, h, n_dir, elem_bytes):
    """Least time for the backward's work: x_proj, ys, the cell states, g,
    the mask, W_h and b_h read and dx_proj written once, dW_h and db_h
    written once in f32; three (B, H) x (H, 4H)-sized products a step and
    direction (recompute, dh, dW) plus ~40 elementwise operations per hidden
    unit, over the f32 peak."""
    gates = 4 * h
    bytes_moved = (elem_bytes * (2 * t * b * n_dir * gates + 3 * t * b * n_dir * h
                                 + n_dir * h * gates + n_dir * gates)
                   + 4 * t * b + 4 * n_dir * (h * gates + gates))
    flops = n_dir * t * b * (3 * 2 * h * gates + 40 * h)
    by_bytes, by_ops = bytes_moved / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def time_lstm():
    """Both LSTM kernels at LSTM_SHAPES (T = 128, H = 128, both directions,
    f32): back to back and by profiler device time (the backward's main
    kernel and its partial-sum kernel apart), the forward also by graph_ms,
    their plain versions, the bounds, and cuDNN's nn.LSTM on full-length
    rows as the yardstick: its inference forward, and its backward timed
    alone (cudnn_bwd_ms); both kernels' launch geometry and microseconds a
    step (the forward's from graph_ms, the backward's back to back).
    Returns {kernel: {B: numbers}}."""
    results = {"lstm_fwd": {}, "lstm_bwd": {}}
    for t, b, h in LSTM_SHAPES:
        xp, wh, bh, mask = lstm_inputs(t, b, h, 2, torch.float32, seed=1)
        ys, cs = hopper_lstm.lstm_forward(xp, wh, bh, mask, 0b10, with_cells=True)
        gy = torch.randn(t, b, 2 * h, device="cuda")

        def fwd():
            return hopper_lstm.lstm_forward(xp, wh, bh, mask, 0b10)

        def bwd():
            return hopper_lstm.lstm_backward(xp, wh, bh, mask, ys, cs, gy, 0b10)

        cudnn = torch.nn.LSTM(h, h, bidirectional=True).cuda()
        x = torch.randn(t, b, h, device="cuda")
        with torch.inference_mode():
            cudnn_fwd_ms = cuda_ms(lambda: cudnn(x), 20)
        cudnn_bwd, cudnn_bwd_device = cudnn_bwd_ms(torch.nn.LSTM, t, b, h)
        fwd_graph_ms = graph_ms(fwd, 20)
        results["lstm_fwd"][b] = dict(ms=cuda_ms(fwd, 20), graph_ms=fwd_graph_ms,
                                      device_ms=kernel_device_ms(fwd, 10, "lstm_fwd"),
                                      plain_ms=cuda_ms(lambda: hopper_lstm.lstm_forward_reference(
                                          xp, wh, bh, mask, 0b10), 3),
                                      **dict(zip(("bound_ms", "bound_by"),
                                                 lstm_bound_ms(t, b, h, 2, 4))),
                                      library_ms=cudnn_fwd_ms, us_per_step=fwd_graph_ms * 1e3 / t,
                                      geometry=geometry_fields(b, 2, h, 4, torch.float32))
        bwd_ms = cuda_ms(bwd, 20)
        results["lstm_bwd"][b] = dict(ms=bwd_ms, **split_device_ms(bwd, "lstm_bwd"),
                                      plain_ms=cuda_ms(lambda: hopper_lstm.lstm_backward_reference(
                                          xp, wh, bh, mask, ys, cs, gy, 0b10), 3),
                                      **dict(zip(("bound_ms", "bound_by"),
                                                 lstm_bwd_bound_ms(t, b, h, 2, 4))),
                                      library_ms=cudnn_bwd, library_device_ms=cudnn_bwd_device,
                                      us_per_step=bwd_ms * 1e3 / t,
                                      geometry=bwd_geometry_fields(b, 2, h, 4, torch.float32))
        for name in ("lstm_fwd", "lstm_bwd"):
            phase("timing", kernel=name, T=t, B=b, H=h, directions=2, dtype="float32",
                  **fmt({k: v for k, v in results[name][b].items() if k != "geometry"}),
                  **results[name][b].get("geometry", {}))
    return results


def time_p2cp():
    """The kernel at the metric's R = 12*128*10 rows by graph_ms (device time
    without host gaps) and back to back, its plain version, torch.cdist +
    amin + mean (the yardstick) and the bound."""
    u, v = p2cp_inputs(P2CP_ROWS, seed=9)
    kernel_ms = cuda_ms(lambda: hopper_p2cp.mean_p2cp_channel_major(u, v), 50)
    kernel_graph_ms = graph_ms(lambda: hopper_p2cp.mean_p2cp_channel_major(u, v), 50)
    plain_ms = cuda_ms(lambda: hopper_p2cp.mean_p2cp_channel_major_reference(u, v), 10)
    up, vp = u.transpose(-1, -2), v.transpose(-1, -2)

    def library():
        d = torch.cdist(up, vp, compute_mode="donot_use_mm_for_euclid_dist")
        return (d.amin(dim=-1).mean(dim=-1) + d.amin(dim=-2).mean(dim=-1)) / 2.0

    lib_err = (library() - hopper_p2cp.mean_p2cp_channel_major(u, v)).abs().max().item()
    library_ms = cuda_ms(library, 10)
    bound_ms, bound_by = p2cp_bound_ms(P2CP_ROWS, 50, 50)
    result = dict(ms=kernel_ms, graph_ms=kernel_graph_ms, share_of_bound=bound_ms / kernel_graph_ms,
                  plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    phase("timing", kernel="p2cp", rows=P2CP_ROWS, N=50, M=50, dtype="float32",
          library_max_abs_diff=f"{lib_err:.3g}", **fmt(result),
          **p2cp_geometry_fields(P2CP_ROWS, 50, 50))
    return result


def cdist_min_distance(u, v):
    """The min-distance yardstick on channel-major (R, 2, N) / (R, 2, M):
    torch.cdist, a flat argmin and a gather. It takes the sqrt before the
    argmin, so near-ties may pick another pair."""
    m = v.shape[-1]
    d = torch.cdist(u.transpose(-1, -2), v.transpose(-1, -2),
                    compute_mode="donot_use_mm_for_euclid_dist").flatten(-2)
    arg = d.argmin(dim=-1)
    return d.gather(-1, arg[:, None])[:, 0], arg // m, arg % m


def library_tvs(stack):
    """A stack's four TVs, (4, R, 5) as plain_tvs packs them, by the plain
    route with cdist_min_distance in place of the broadcast formula."""
    names, problems = tract_variables.tv_table({a: stack.shape[-1] for a in TV_STACK_ARTS})
    sources = [stack[..., TV_STACK_ARTS.index(n), :, :] for n in names]

    def cut(w):
        return sources[w.source][..., w.start:w.start + w.count]

    out = []
    for u_window, v_windows in problems:
        u, v = cut(u_window), torch.cat([cut(w) for w in v_windows], dim=-1)
        value, i, j = cdist_min_distance(u, v)
        out.append(torch.cat([value[:, None], u.gather(-1, i[:, None, None].expand(-1, 2, 1))[..., 0],
                              v.gather(-1, j[:, None, None].expand(-1, 2, 1))[..., 0]], dim=-1))
    return torch.stack(out)


def time_min_dist():
    """Each TV shape at the thesis test batch's R = 12*128 rows through the
    single entry: the kernel by graph_ms and back to back, its plain version,
    cdist_min_distance (the yardstick) and the bound. Then one stack's four
    TVs as the test step computes them (tract_variables_from_stack on a (R,
    11, 2, 50) stack): graph_ms, back to back and min_dist launches a call,
    beside the plain TV route (plain_tvs) and the yardstick's (library_tvs)
    on the same stack. Returns the stack's numbers (one side of a test step:
    predictions or targets) with the shapes' under "by_tv"."""
    results = {}
    for tv, (n, m) in TV_SHAPES.items():
        u, v = min_dist_inputs(TEST_ROWS, n, m, seed=n * m)
        kernel_ms = cuda_ms(lambda: hopper_min_dist.min_distance_channel_major(u, v), 100)
        kernel_graph_ms = graph_ms(lambda: hopper_min_dist.min_distance_channel_major(u, v), 100)
        plain_ms = cuda_ms(lambda: hopper_min_dist.min_distance_channel_major_reference(u, v), 20)

        def library():
            return cdist_min_distance(u, v)

        lib, got = library(), hopper_min_dist.min_distance_channel_major(u, v)
        same_pair = ((lib[1] == got[1]) & (lib[2] == got[2])).float().mean().item()
        lib_diff = (lib[0] - got[0]).abs().max().item()
        library_ms = cuda_ms(library, 20)
        bound_ms, bound_by = min_dist_bound_ms(TEST_ROWS, [(n, m)])
        results[tv] = dict(ms=kernel_ms, graph_ms=kernel_graph_ms,
                           share_of_bound=bound_ms / kernel_graph_ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
        phase("timing", kernel="min_dist", tv=tv, rows=TEST_ROWS, N=n, M=m, dtype="float32",
              library_max_abs_diff=f"{lib_diff:.3g}", library_same_pair_share=f"{same_pair:.4f}",
              **fmt(results[tv]), **min_dist_geometry_fields(TEST_ROWS, [(n, m)]))
    stack = tv_stack(TEST_ROWS, seed=24)

    def four_tvs():
        return tract_variables.tract_variables_from_stack(stack, TV_STACK_ARTS)

    before = hopper_min_dist.launches
    four_tvs()
    launches = hopper_min_dist.launches - before
    lib_diff = (library_tvs(stack)[..., 0] - kernel_tvs(stack)[..., 0]).abs().max().item()
    total = dict(ms=cuda_ms(four_tvs, 100), graph_ms=graph_ms(four_tvs, 100),
                 plain_ms=cuda_ms(lambda: plain_tvs(stack), 20),
                 library_ms=cuda_ms(lambda: library_tvs(stack), 20))
    total["bound_ms"], total["bound_by"] = min_dist_bound_ms(TEST_ROWS, list(TV_SHAPES.values()))
    total["share_of_bound"] = total["bound_ms"] / total["graph_ms"]
    phase("timing", kernel="min_dist", tv="LA+TTCD+TBCD+VEL", stack=f"({TEST_ROWS},11,2,50)",
          dtype="float32", launches_per_call=launches, library_max_abs_diff=f"{lib_diff:.3g}",
          **fmt(total),
          **min_dist_geometry_fields(TEST_ROWS, list(TV_SHAPES.values())))
    return {**total, "launches_per_call": launches, "by_tv": results}


def time_test_step():
    """The thesis test step at B=12, T=128, every frame valid: 10
    articulators and the incisor, metrics, TVs of predictions and targets."""
    arts = sorted(RECOGNITION_ARTICULATORS)
    model = ArtSpeech(VOCAB, len(arts), generator=torch.Generator().manual_seed(2))
    step, _ = make_test_step(model, arts)
    batch = fixed_batch(12, 128, seed=6, device="cuda", ragged=False)
    batch["references"] = torch.rand(12, 128, 1, 2, 50, generator=torch.Generator().manual_seed(6),
                                     device="cpu").cuda()
    hopper_min_dist.launches = 0
    step(batch)
    torch.cuda.synchronize()
    per_step = hopper_min_dist.launches
    step_ms = host_ms(lambda: step(batch), 10)
    phase("timing", test_step_ms=f"{step_ms:.6g}",
          test_frames_per_s=f"{12 * 128 / step_ms * 1e3:.6g}", min_dist_launches_per_step=per_step,
          shape="B=12,T=128,arts=10+incisor,tvs_pred_and_target")
    device_breakdown(lambda: step(batch), step_ms, "test_B12")


def time_synthesis():
    run = bench_step(None)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, VOCAB, (BENCH_B, BENCH_T)).astype(np.int32)
    lengths = np.full(BENCH_B, BENCH_T, np.int32)
    step_ms = host_ms(lambda: run(tokens, lengths), 10)
    phase("timing", synthesis_step_ms=f"{step_ms:.6g}",
          synthesis_frames_per_s=f"{BENCH_B * BENCH_T / step_ms * 1e3:.6g}",
          shape=f"B={BENCH_B},T={BENCH_T},arts=11,with_area_function")
    device_breakdown(lambda: run(tokens, lengths), step_ms, "synthesis")


def time_training():
    """The thesis train step (dropout 0.1, AdamW) at T=128, every frame valid."""
    for b in (TRAIN["batch"], 256):
        st = thesis_state(None)
        batch = fixed_batch(b, 128, seed=5, device="cuda", ragged=False)
        step = make_artspeech_train_step(TO_MM)
        gen = torch.Generator(device="cuda").manual_seed(0)
        step_ms = host_ms(lambda: step(st, batch, gen), 10)
        frames = int(batch["lengths"].sum())
        phase("timing", train_step_ms=f"{step_ms:.6g}",
              train_frames_per_s=f"{frames / step_ms * 1e3:.6g}",
              shape=f"B={b},T=128,arts=10,dropout=0.1,adamw")
        device_breakdown(lambda: step(st, batch, gen), step_ms, f"train_B{b}")


def kernel_entry(name, launches, by_path, max_err, numbers, shape, **extra):
    return {"name": name, "route": "cuda",
            "source": f"artspeech_tpu_torch/ops/csrc/{LIBRARY[name]}.cu",
            "replaces": REPLACES[name], "launches": launches, "launches_by_path": by_path,
            "max_abs_err": max_err, "ms": numbers["ms"], "plain_ms": numbers["plain_ms"],
            "bound_ms": numbers["bound_ms"], "bound_by": numbers["bound_by"],
            "library_ms": numbers["library_ms"], "shape": shape, **extra}


def main():
    start = time.perf_counter()

    def elapsed(after):
        phase("elapsed", after=after, seconds=f"{time.perf_counter() - start:.1f}")

    check(torch.cuda.is_available(), "chip_smoke.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    phase("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    build_all()
    elapsed("build")
    errs = {"gru_fwd": gru_fwd_vs_plain(), "p2cp": p2cp_vs_plain(),
            "min_dist": min_dist_vs_plain(), "flash_decode": flash_decode_vs_plain()}
    errs["gru_bwd"], bwd_rel_err = gru_bwd_vs_plain()
    errs["train_attention_fwd"], errs["train_attention_bwd"] = train_attention_vs_plain()
    errs["lstm_fwd"] = lstm_fwd_vs_plain()
    errs["lstm_bwd"], lstm_bwd_rel_err = lstm_bwd_vs_plain()
    errs["gru_seq"] = gru_seq_vs_plain()
    gru_seq_launches = gru_seq_path()
    elapsed("kernel_checks")
    t0 = time.perf_counter()
    wide = widths()
    phase("widths", seconds=f"{time.perf_counter() - t0:.3f}")
    with tempfile.TemporaryDirectory() as tmp:
        synthesis_launches = main_path(tmp)
    against_cpu()
    with tempfile.TemporaryDirectory() as tmp:
        train_launches = train_path(tmp)
    loss_falls()
    train_against_cpu()
    elapsed("main_and_train")
    parallel_launches = parallel_path()
    elapsed("parallel")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cli_launches, cli_seconds, test_step_inputs = cli_path(tmp)
        test_step_against_cpu(*test_step_inputs)
        phase("cli", seconds=f"{time.perf_counter() - t0:.3f}")
        t0 = time.perf_counter()
        pc_launches, pc_seconds = pc_path(tmp, *test_step_inputs[1:3])
        phase("pc", seconds=f"{time.perf_counter() - t0:.3f}")
        t0 = time.perf_counter()
        mc_launches, mc_seconds = mean_contour_path(tmp, *test_step_inputs[1:3])
        phase("mean_contour", seconds=f"{time.perf_counter() - t0:.3f}")
        t0 = time.perf_counter()
        rec_launches, rec_seconds, rec_cfg = recognizer_path(tmp, *test_step_inputs[1:3])
        corpus = test_step_inputs[1]
        recognizer_eval_against_cpu(
            PhonemeRecognitionDataset(corpus, "gottingen",
                                      sequences_from_dict(corpus, rec_cfg["test_seq_dict"]),
                                      load_vocabulary(rec_cfg["vocab_filepath"]),
                                      ["vocal_tract"]),
            rec_cfg, "recognizer", "train_vocal_tract")
        recognizer_train_against_cpu(rec_cfg)
        recognizer_loss_falls(rec_cfg)
        phase("recognizer", seconds=f"{time.perf_counter() - t0:.3f}")
        t0 = time.perf_counter()
        syn_launches, syn_seconds = synthetic_path(tmp, *test_step_inputs[1:3])
        frozen_gru_vs_plain()
        frozen_launches = frozen_steps_path(rec_cfg)
        frozen_step_against_f64(rec_cfg)
        phase("synthetic", seconds=f"{time.perf_counter() - t0:.3f}")
        t0 = time.perf_counter()
        surface_launches = surfaces_path(tmp, corpus, test_step_inputs[2], test_step_inputs[0])
        phase("surfaces", seconds=f"{time.perf_counter() - t0:.3f}")
    elapsed("cli_pc_mean_contour_recognizer_synthetic_surfaces")
    decode_launches = decode_path()
    decode_against_cpu()
    elapsed("decode")
    train_transformer_launches = train_transformer_path()
    transformer_loss_falls()
    transformer_train_against_cpu()
    t0 = time.perf_counter()
    long_bucket_launches = long_bucket_path()
    phase("train_transformer", long_bucket_seconds=f"{time.perf_counter() - t0:.3f}")
    t0 = time.perf_counter()
    latent_launches = latent_rnn_path()
    latent_rnn_loss_falls()
    latent_rnn_train_against_cpu()
    phase("latent_rnn", seconds=f"{time.perf_counter() - t0:.3f}")
    elapsed("train_transformer_and_latent_rnn")

    flash = time_flash_decode()
    elapsed("time_flash_decode")
    train_attention = time_train_attention()
    gru_fwd = time_gru_fwd()
    gru_bwd = time_gru_bwd()
    half_gru = time_half_gru()
    numbers = {"gru_fwd": gru_fwd[(BENCH_T, BENCH_B)], "gru_bwd": gru_bwd[BENCH_B],
               "p2cp": time_p2cp(), "min_dist": time_min_dist(),
               "flash_decode": flash[(12, torch.float32, "inter", DECODE_T)],
               **{k: train_attention[(k, TRAIN["batch"], TRAIN_T, HD)]
                  for k in ("train_attention_fwd", "train_attention_bwd")}}
    lstm = time_lstm()
    numbers.update({k: lstm[k][LSTM_SHAPES[0][1]] for k in ("lstm_fwd", "lstm_bwd")})
    gru_seq = time_gru_seq()
    numbers["gru_seq"] = gru_seq[BENCH_B]
    recognizer_gru = time_recognizer_gru(RECOGNIZER_GRU_CASES[0], "recognizer")
    frozen_gru = time_recognizer_gru(FROZEN_GRU, "frozen_recognizer")
    t0 = time.perf_counter()
    time_recognizer_steps()
    phase("timing", recognizer_steps_seconds=f"{time.perf_counter() - t0:.3f}")
    time_recognizer_conv()
    time_synthesis()
    time_training()
    time_test_step()
    phase("timing", **{f"{p}_wall_s": f"{s:.3f}"
                       for p, s in {**cli_seconds, **pc_seconds, **mc_seconds,
                                    **rec_seconds, **syn_seconds}.items()})

    by_path = {k: {"synthesis": synthesis_launches if k == "gru_fwd" else 0,
                   "train": train_launches.get(k, 0),
                   **{p: c.get(k, 0) for p, c in parallel_launches.items()},
                   **{p: cli_launches[p][k] for p in CLI_PATHS},
                   "decode": decode_launches if k == "flash_decode" else 0,
                   "train_transformer": train_transformer_launches[k],
                   "train_transformer_long_bucket": long_bucket_launches[k],
                   **{p: pc_launches[p][k] for p in PC_PATHS},
                   **{p: mc_launches[p][k] for p in MC_PATHS},
                   "latent_rnn": latent_launches[k],
                   **{p: rec_launches[p][k] for p in REC_PATHS},
                   **{p: syn_launches[p][k] for p in SYNTHETIC_PATHS},
                   "frozen_recognizer_steps": frozen_launches[k],
                   **{p: surface_launches[p][k] for p in surface_launches},
                   "gru_seq": gru_seq_launches if k == "gru_seq" else 0} for k in KERNELS}
    unlaunched = [k for k in KERNELS if sum(by_path[k].values()) == 0]
    check(not unlaunched, f"kernels launched on no path: {unlaunched}")
    gru_shape = f"T={BENCH_T},B={BENCH_B},H={HIDDEN},directions=2,float32"
    shapes = {"gru_fwd": gru_shape, "gru_bwd": gru_shape, "p2cp": f"R={P2CP_ROWS},N=50,M=50,float32",
              "min_dist": f"one stack's four TVs, tract_variables_from_stack of ({TEST_ROWS},11,2,50),"
                          " (N,M)=" + ",".join(f"({n},{m})" for n, m in TV_SHAPES.values())
                          + ",float32",
              "flash_decode": f"inter B=12: S={DECODE_T},hd={HD},G={flash_groups(12)['inter']},"
                              f"n_rows={DECODE_T},float32",
              **{k: f"B=12: G={TRAIN_ATTN_G[12]},L={TRAIN_T},hd={HD},"
                    f"n_pairs={TRAIN_ATTN_PAIRS} (dropout 0.1 keep),float32"
                 for k in ("train_attention_fwd", "train_attention_bwd")},
              **{k: "T={},B={},H={},directions=2,float32".format(*LSTM_SHAPES[0])
                 for k in ("lstm_fwd", "lstm_bwd")},
              "gru_seq": f"B={BENCH_B},T={BENCH_T},H={HIDDEN},directions=1,batch_tile=16,float32"}
    extra = {"gru_bwd": {"rel_err": bwd_rel_err},
             "p2cp": {k: numbers["p2cp"][k] for k in ("graph_ms", "share_of_bound")},
             "min_dist": {k: numbers["min_dist"][k]
                          for k in ("graph_ms", "share_of_bound", "launches_per_call", "by_tv")},
             **{k: {"device_ms": lstm[k][LSTM_SHAPES[0][1]]["device_ms"],
                    "by_shape": {f"B={b}": r for b, r in lstm[k].items()}}
                for k in ("lstm_fwd", "lstm_bwd")},
             "flash_decode": {
                 **{k: flash[(12, torch.float32, "inter", DECODE_T)][k]
                    for k in ("graph_ms", "library_graph_ms", "device_ms", "host_us")},
                 "sweep": {f"B={b},{str(d).split('.')[-1]}": r
                           for (b, d, *what), r in flash.items() if what == ["sweep"]},
                 "by_shape": {f"B={b},{str(d).split('.')[-1]}": r
                              for (b, d, *what), r in flash.items()
                              if what == ["inter", DECODE_T]}},
             **{k: {"device_ms": train_attention[(k, TRAIN["batch"], TRAIN_T, HD)]["device_ms"],
                    "by_shape": {f"B={b},L={l},hd={hd}": r
                                 for (n, b, l, hd), r in train_attention.items() if n == k}}
                for k in ("train_attention_fwd", "train_attention_bwd")}}
    extra["lstm_bwd"]["rel_err"] = lstm_bwd_rel_err
    extra["lstm_fwd"]["graph_ms"] = lstm["lstm_fwd"][LSTM_SHAPES[0][1]]["graph_ms"]
    extra["gru_seq"] = {"by_shape": {f"B={b}": r for b, r in gru_seq.items()}}
    extra["gru_fwd"] = {"by_shape": {f"B={b}": r for (_, b), r in gru_fwd.items()}}
    extra["gru_bwd"]["by_shape"] = {f"B={b}": r for b, r in gru_bwd.items()}
    extra["gru_bwd"]["device_ms"] = gru_bwd[BENCH_B]["device_ms"]
    for k in ("gru_fwd", "gru_bwd"):
        extra[k]["by_dtype"] = {
            "shape": f"T={BENCH_T},B={GRU_FWD_TIMED_B[0]},H={HIDDEN},directions=2",
            **{d: r for (n, d), r in half_gru.items() if n == k}}
        extra[k]["recognizer"] = {"shape": "T={},B={},H={},directions=1,float32".format(
            *RECOGNIZER_GRU_CASES[0]), **recognizer_gru[k]}
        extra[k]["frozen_recognizer"] = {"shape": "T={},B={},H={},directions=1,float32".format(
            *FROZEN_GRU), **frozen_gru[k]}
    for k, w in wide.items():
        extra.setdefault(k, {}).update(w)
    for k in KERNELS:
        extra.setdefault(k, {})["dtypes"] = DTYPES_HELD[k]
    elapsed("timing")
    line = {"kernels": [kernel_entry(k, sum(by_path[k].values()), by_path[k], errs[k], numbers[k],
                                     shapes[k], **extra.get(k, {})) for k in KERNELS]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
