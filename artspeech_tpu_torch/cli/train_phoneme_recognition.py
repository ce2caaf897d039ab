"""The phoneme-recognition trainer's entry point (counterpart of
artspeech_tpu/cli/train_phoneme_recognition.py), which is not ported yet.

The recognizer (DeepSpeech2 with its Adapter, the recognition datasets,
losses, steps and metrics) is ROADMAP Queue 1, item 3, and so are its configs
in configs/phoneme_recognition/, the bf16 one (train_vocal_tract_bf16.yaml)
among them: every config raises ``NotImplementedError`` here rather than
``ModuleNotFoundError``.

Usage: python -m artspeech_tpu_torch.cli.train_phoneme_recognition --config cfg.yaml
"""

from artspeech_tpu_torch.cli.common import run_experiment


def main(cfg, args, tracker):
    raise NotImplementedError(
        "phoneme recognition (DeepSpeech2, configs/phoneme_recognition/) is not ported to "
        "artspeech_tpu_torch yet: ROADMAP Queue 1, item 3")


if __name__ == "__main__":
    run_experiment("Train phoneme recognition", main)
