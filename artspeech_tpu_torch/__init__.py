"""artspeech_tpu_torch — the PyTorch/CUDA port of artspeech_tpu for one NVIDIA H100.

The JAX package ``artspeech_tpu`` stays the reference; this package mirrors its
layout (core/, ops/, models/, geometry/, synth/, utils/, data/, losses/,
train/, eval/, cli/, parallel/) and names, so each module's counterpart is
found at the same path. It imports torch and numpy, never jax or anything of
``artspeech_tpu``: what it needs of the framework-free JAX modules
(constants, vocabulary, the semipolar grid, the B-spline basis, the canonical
incisor, the corpus readers, the synthetic corpora, the tracker) is copied
here.

Every TPU Pallas kernel on a ported path becomes a hand-written Hopper kernel
under ``ops/csrc/``, built with nvcc at first use. A kernel's wrapper takes its
plain PyTorch version only for CPU tensors; for CUDA tensors it launches the
kernel or raises. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, and raise when no CUDA device is present.

Ported so far: the synthesis (serving) path — ArtSpeech forward with the
masked-GRU forward kernel, B-spline smoothing, incisor injection, vocal-tract
tube walls and the semipolar-grid area function; and the training path —
the GRU backward kernel behind a ``torch.autograd.Function``, training-mode
dropout, the masked-Euclidean loss, the P2CP metric kernel, the train and
eval steps with AdamW, checkpoints and ``fit`` (losses/, train/); and the
model-free thesis workflow through its CLIs (cli/): corpora on disk (data/),
the test harness with tract variables on the min-distance kernel (eval/,
geometry/tract_variables.py), and the train, test and generate CLIs. Every
module of the JAX package has its counterpart, data parallelism over
``torch.distributed`` (parallel/) the last.
"""

__version__ = "0.1.0"
