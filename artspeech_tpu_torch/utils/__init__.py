"""The reference-checkpoint importers, exported as the JAX package's
``utils`` exports them. They load on first use: ``torch_import`` imports the
models, which import ``utils.masks``."""

_TORCH_IMPORT = ("convert_artspeech_state_dict", "convert_deepspeech2_state_dict",
                 "load_librispeech_deepspeech2", "load_torch_state_dict")
__all__ = list(_TORCH_IMPORT)


def __getattr__(name):
    if name in _TORCH_IMPORT:
        from artspeech_tpu_torch.utils import torch_import

        return getattr(torch_import, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
