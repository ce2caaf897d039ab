"""Train the latent sequence model, phonemes -> principal components
(counterpart of artspeech_tpu/cli/train_phoneme_to_principal_components.py).

Equivalent of reference train_phoneme_to_principal_components.py:58-471:
``PrincipalComponentsArtSpeech`` (BiGRU or BiLSTM, ``model_kwargs.rnn``)
trained with the AutoencoderLoss composite over a frozen autoencoder (latent
MSE, decoded-contour MSE, the critical TV loss and, with a ``recognizer:``
block, ``beta4`` times the feature MSE of a frozen DeepSpeech2), valid metric
the decoder P2CP in mm, through ``fit``; then the final test with TV and
contour dumps. Data-parallel over torchrun's ranks as the model-free trainer
(cli/train_phoneme_to_articulation.py); rank 0 writes and tests.

Usage: python -m artspeech_tpu_torch.cli.train_phoneme_to_principal_components \
           --config cfg.yaml [--output_dir results] [--device cpu]
Config keys: datadir, database_name, num_epochs, batch_size, patience,
learning_rate, weight_decay, indices_dict, vocab_filepath,
encoder_state_dict_filepath, decoder_state_dict_filepath, encoder_cls,
decoder_cls, in_features, hidden_features, beta1..beta4, rescale_factor,
TV_to_phoneme_map, model_kwargs (rnn=GRU|LSTM), recognizer (optional:
{state_dict_filepath, model_params}), clip_tails, seed.
"""

import json
import os

import torch

from artspeech_tpu_torch.cli.common import model_kwargs_from_cfg, run_experiment
from artspeech_tpu_torch.core.config import DATASET_CONFIG, mm_per_unit
from artspeech_tpu_torch.core.device import resolve_device
from artspeech_tpu_torch.core.vocab import load_vocabulary
from artspeech_tpu_torch.data.batching import BucketedLoader
from artspeech_tpu_torch.data.pc_datasets import (
    PrincipalComponentsDataset,
    load_norm_stats,
    stack_norm_stats,
)
from artspeech_tpu_torch.eval.autoencoder import run_latent_rnn_test
from artspeech_tpu_torch.losses.autoencoder import make_autoencoder_loss
from artspeech_tpu_torch.models.autoencoder import (
    MultiDecoder,
    MultiEncoder,
    normalize_indices_dict,
)
from artspeech_tpu_torch.models.deepspeech2 import DeepSpeech2, frozen_recognizer_fn
from artspeech_tpu_torch.models.latent_rnn import PrincipalComponentsArtSpeech
from artspeech_tpu_torch.parallel.distributed import is_main_process
from artspeech_tpu_torch.parallel.mesh import world
from artspeech_tpu_torch.train.checkpoint import load_params, restore_checkpoint
from artspeech_tpu_torch.train.loop import fit
from artspeech_tpu_torch.train.pc_step import (
    make_latent_rnn_eval_step,
    make_latent_rnn_train_step,
)
from artspeech_tpu_torch.train.state import count_parameters, create_train_state
from artspeech_tpu_torch.utils.io import sequences_from_dict


def _frozen(module):
    module.requires_grad_(False)
    return module.eval()


def build_frozen_ae(cfg, indices_dict, require_encoder=True, device=None):
    """Frozen encoder/decoder callables over loaded parameters, on ``device``.

    The encoder is optional ONLY for synthesis-time callers: those configs
    ship just the decoder (reference generate_vocal_tract_shape_autoencoder.yaml
    carries only the decoder's state dict), and they pass
    ``require_encoder=False`` to get ``encode_fn=None``. Training callers
    need the encoder for the composite loss, so a missing
    ``encoder_state_dict_filepath`` raises here, at config-read time.
    Returns (encode_fn: x -> tanh(encoder(x)) or None, decoder module).
    """
    dev = resolve_device(device)
    kwargs = dict(indices_dict=indices_dict, in_features=cfg.get("in_features", 100),
                  hidden_features=cfg.get("hidden_features", 50))
    if require_encoder and not cfg.get("encoder_state_dict_filepath"):
        raise KeyError("encoder_state_dict_filepath is required for training "
                       "(decoder-only configs are only valid for synthesis callers)")
    encode_fn = None
    if cfg.get("encoder_state_dict_filepath"):
        encoder = MultiEncoder(**kwargs, encoder_cls=cfg.get("encoder_cls", "AE"), device=dev)
        encoder.load_state_dict(load_params(cfg["encoder_state_dict_filepath"]))
        encoder = _frozen(encoder)

        def encode_fn(x):
            return torch.tanh(encoder(x))

    decoder = MultiDecoder(**kwargs, decoder_cls=cfg.get("decoder_cls", "AE"), device=dev)
    decoder.load_state_dict(load_params(cfg["decoder_state_dict_filepath"]))
    return encode_fn, _frozen(decoder)


def build_frozen_recognizer(cfg, vocabulary, device=None):
    """The config's ``recognizer:`` block as a frozen feature extractor, or
    None without one: ``DeepSpeech2(**model_params)`` loaded from its
    ``state_dict_filepath`` on ``device``
    (``models.deepspeech2.frozen_recognizer_fn``)."""
    rec_cfg = cfg.get("recognizer")
    if not rec_cfg:
        return None
    model = DeepSpeech2(num_classes=len(vocabulary),
                        **model_kwargs_from_cfg({"model_params": rec_cfg.get("model_params")},
                                                "model_params"),
                        device=resolve_device(device))
    model.load_state_dict(load_params(rec_cfg["state_dict_filepath"]))
    return frozen_recognizer_fn(model)


def main(cfg, args, tracker):
    device = resolve_device(args.device)
    database_name = cfg["database_name"]
    to_mm = mm_per_unit(DATASET_CONFIG[database_name])
    vocabulary = load_vocabulary(cfg["vocab_filepath"])
    indices_dict = normalize_indices_dict(cfg["indices_dict"])
    articulators = sorted(indices_dict.keys())
    datadir = cfg["datadir"]
    seed = cfg.get("seed", 0)

    norm_stats = load_norm_stats(datadir, articulators)
    denorm_mean, denorm_std = stack_norm_stats(norm_stats, articulators)

    n_ranks, _ = world()
    loaders = {}
    for split, key, shuffle in (("train", "train_seq_dict", True),
                                ("valid", "valid_seq_dict", False),
                                ("test", "test_seq_dict", False)):
        dataset = PrincipalComponentsDataset(
            datadir, database_name, sequences_from_dict(datadir, cfg[key]), vocabulary,
            articulators, TV_to_phoneme_map=cfg.get("TV_to_phoneme_map"),
            clip_tails=cfg.get("clip_tails", True), norm_stats=norm_stats)
        loaders[split] = BucketedLoader(dataset, batch_size=cfg["batch_size"], shuffle=shuffle,
                                        seed=seed, pad_to_multiple=n_ranks)

    encode_fn, decode_fn = build_frozen_ae(cfg, indices_dict, device=device)
    tvs = sorted((cfg.get("TV_to_phoneme_map") or {}).keys())
    rescale = cfg.get("rescale_factor", 1.0)
    loss_fn = make_autoencoder_loss(
        encode_fn, decode_fn, tvs, articulators, beta1=cfg.get("beta1", 1.0),
        beta2=cfg.get("beta2", 1.0), beta3=cfg.get("beta3", 1.0), beta4=cfg.get("beta4", 0.0),
        rescale_factor=rescale, denorm_mean=torch.as_tensor(denorm_mean, device=device),
        denorm_std=torch.as_tensor(denorm_std, device=device),
        recognizer_fn=build_frozen_recognizer(cfg, vocabulary, device))

    model = PrincipalComponentsArtSpeech(
        len(vocabulary), indices_dict, **model_kwargs_from_cfg(cfg),
        generator=torch.Generator().manual_seed(seed), device=device)
    state = create_train_state(model, cfg["learning_rate"], cfg.get("weight_decay", 0.0))
    n_params = count_parameters(model)
    tracker.log_params({"num_network_params": n_params})
    print(f"PrincipalComponentsArtSpeech -- {n_params} parameters")

    result = fit(
        state,
        loaders["train"],
        loaders["valid"],
        None,
        None,
        train_step_factory=lambda mesh: make_latent_rnn_train_step(
            loss_fn, decode_fn, denorm_mean, denorm_std, to_mm, rescale, device=device,
            mesh=mesh),
        eval_step_factory=lambda mesh: make_latent_rnn_eval_step(
            loss_fn, decode_fn, denorm_mean, denorm_std, to_mm, rescale, device=device,
            mesh=mesh),
        n_epochs=cfg["num_epochs"],
        checkpoints_dir=os.path.join(args.output_dir, "checkpoints"),
        monitor="p2cp_mm",
        patience=cfg.get("patience", 30),
        tracker=tracker,
        seed=seed,
        resume=args.checkpoint_filepath is not None,
        resume_from=args.checkpoint_filepath,
        device=device,
    )
    if not is_main_process():
        return None

    best_state, _ = restore_checkpoint(result.best_params_dir, result.state)
    info = run_latent_rnn_test(best_state.model, decode_fn, loaders["test"], articulators,
                               denorm_mean, denorm_std, to_mm, rescale_factor=rescale,
                               outputs_dir=os.path.join(args.output_dir, "test_outputs", "0"),
                               device=device)
    with open(os.path.join(args.output_dir, "test_results.json"), "w") as f:
        json.dump(info, f, indent=2)
    tracker.log_dict(info, "test_results.json")
    print(json.dumps({"p2cp_mm": info["p2cp_mm"]}, indent=2))
    return info


if __name__ == "__main__":
    run_experiment("Train phoneme-to-principal-components", main)
