"""PCA fitting via SVD (counterpart of artspeech_tpu/ops/pca.py).

Replaces the reference's sklearn ``IncrementalPCA.partial_fit`` loop
(train_articulatory_PCA.py:38-202) with one exact economy SVD per
articulator, ``torch.linalg.svd`` on the host's CPU: the corpora are tens of
thousands of 100-dimensional frames, milliseconds of LAPACK.
"""

from typing import Dict

import numpy as np
import torch


def fit_pca(x: np.ndarray, num_components: int) -> Dict[str, np.ndarray]:
    """Fit PCA on (N, F) data.

    Returns {"mean": (F,), "eigenvectors": (k, F), "eigenvalues": (k,)} in
    float32, the PCAEncoder/PCADecoder parameter schema
    (artspeech_tpu_torch.models.autoencoder). Eigenvalues are the explained
    variances (sklearn convention). The SVD runs in float32 through LAPACK,
    as the JAX package's does on the host. A singular vector's sign is the
    solver's choice (LAPACK builds differ), so an eigenvector may come out
    negated against the JAX package's: the same PCA, with that latent
    component's sign flipped.
    """
    x = torch.as_tensor(np.asarray(x, np.float32))
    mean = x.mean(dim=0)
    _, s, vt = torch.linalg.svd(x - mean, full_matrices=False)
    eigenvalues = (s**2) / max(x.shape[0] - 1, 1)
    return {
        "mean": mean.numpy(),
        "eigenvectors": vt[:num_components].numpy(),
        "eigenvalues": eigenvalues[:num_components].numpy(),
    }


def explained_variance_ratio(eigenvalues: np.ndarray, total_var: float) -> np.ndarray:
    return np.asarray(eigenvalues) / max(total_var, 1e-12)
